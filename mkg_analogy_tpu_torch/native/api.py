"""ctypes bindings for the port's kgsampler library (OpenKE C-ABI parity;
the JAX package's ``native/api.py``; the library is built by
``native.build``).

The call surface matches the reference's Base.so contract
(DATA_/TrainDataLoader.py:41-127, TestDataLoader.py:27-117,
IKRL.py:200-217), so code written against OpenKE's loader API ports 1:1.
Zero-copy: numpy batch buffers are passed as raw pointers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Optional

import numpy as np

from .build import build


class KGSamplerLib:
    """Thin typed wrapper over the shared library."""

    def __init__(self, lib_path: Optional[str] = None):
        self.lib = ctypes.cdll.LoadLibrary(lib_path or build())
        L = self.lib
        L.sampling.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
        L.testHead.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        L.testTail.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        L.test_link_prediction.argtypes = [ctypes.c_int64]
        for name in ("getTestLinkMRR", "getTestLinkMR", "getTestLinkHit1",
                     "getTestLinkHit3", "getTestLinkHit10"):
            fn = getattr(L, name)
            fn.argtypes = [ctypes.c_int64]
            fn.restype = ctypes.c_float
        L.getHeadBatch.argtypes = [ctypes.c_void_p] * 3
        L.getTailBatch.argtypes = [ctypes.c_void_p] * 3
        L.getTestBatch.argtypes = [ctypes.c_void_p] * 6
        for name in ("getEntityTotal", "getRelationTotal", "getTrainTotal",
                     "getTestTotal", "getValidTotal", "getTripleTotal"):
            getattr(L, name).restype = ctypes.c_int64

    def set_in_path(self, path: str) -> None:
        if not path.endswith("/"):
            path += "/"
        buf = ctypes.create_string_buffer(path.encode(), len(path) * 2)
        self.lib.setInPath(buf)


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


class NativeTrainLoader:
    """OpenKE-layout training batches from the native sampler
    (TrainDataLoader parity)."""

    def __init__(
        self,
        in_path: str,
        batch_size: Optional[int] = None,
        nbatches: Optional[int] = None,
        threads: int = 8,
        sampling_mode: str = "normal",
        bern_flag: bool = True,
        filter_flag: bool = True,
        neg_ent: int = 25,
        neg_rel: int = 25,
        lib: Optional[KGSamplerLib] = None,
    ):
        self.klib = lib or KGSamplerLib()
        L = self.klib.lib
        self.klib.set_in_path(in_path)
        L.setBern(int(bern_flag))
        L.setWorkThreads(threads)
        L.randReset()
        L.importTrainFiles()
        self.ent_total = L.getEntityTotal()
        self.rel_total = L.getRelationTotal()
        self.triple_total = L.getTrainTotal()
        if batch_size is None:
            batch_size = self.triple_total // nbatches
        self.batch_size = batch_size
        self.nbatches = self.triple_total // batch_size
        self.neg_ent, self.neg_rel = neg_ent, neg_rel
        self.filter_flag = filter_flag
        self.sampling_mode = sampling_mode
        self._cross = 0
        n = batch_size * (1 + neg_ent + neg_rel)
        self.batch_h = np.zeros(n, np.int64)
        self.batch_t = np.zeros(n, np.int64)
        self.batch_r = np.zeros(n, np.int64)
        self.batch_y = np.zeros(n, np.float32)

    def _sample(self, mode: int) -> None:
        self.klib.lib.sampling(
            _addr(self.batch_h), _addr(self.batch_t), _addr(self.batch_r),
            _addr(self.batch_y), self.batch_size, self.neg_ent, self.neg_rel,
            mode, int(self.filter_flag), 0, 0,
        )

    def sample_normal(self) -> Dict[str, np.ndarray]:
        self._sample(0)
        return dict(batch_h=self.batch_h, batch_t=self.batch_t,
                    batch_r=self.batch_r, batch_y=self.batch_y, mode="normal")

    def sample_cross(self) -> Dict[str, np.ndarray]:
        self._cross = 1 - self._cross
        bs = self.batch_size
        if self._cross == 0:
            self._sample(-1)
            return dict(batch_h=self.batch_h, batch_t=self.batch_t[:bs],
                        batch_r=self.batch_r[:bs], batch_y=self.batch_y,
                        mode="head_batch")
        self._sample(1)
        return dict(batch_h=self.batch_h[:bs], batch_t=self.batch_t,
                    batch_r=self.batch_r[:bs], batch_y=self.batch_y,
                    mode="tail_batch")

    def __len__(self) -> int:
        return self.nbatches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(self.nbatches):
            if self.sampling_mode == "normal":
                yield self.sample_normal()
            else:
                yield self.sample_cross()


class NativeTestLoader:
    """Per-triple full-candidate batches + streamed metric accumulation
    (TestDataLoader + Tester.run_link_prediction parity)."""

    def __init__(self, in_path: str, type_constrain: bool = False,
                 lib: Optional[KGSamplerLib] = None):
        self.klib = lib or KGSamplerLib()
        L = self.klib.lib
        self.klib.set_in_path(in_path)
        L.randReset()
        L.importTrainFiles()
        L.importTestFiles()
        if type_constrain:
            L.importTypeFiles()
        self.type_constrain = type_constrain
        self.ent_total = L.getEntityTotal()
        self.test_total = L.getTestTotal()
        self._h = np.zeros(self.ent_total, np.int64)
        self._t = np.zeros(self.ent_total, np.int64)
        self._r = np.zeros(self.ent_total, np.int64)

    def run_link_prediction(self, score_fn) -> Dict[str, float]:
        """score_fn(batch_h, batch_t, batch_r, mode) -> (E,) float32 energies
        (lower = better). Streams per-triple scores into the C accumulator
        exactly like Tester.run_link_prediction (IKRL.py:276-297)."""
        L = self.klib.lib
        L.initTest()
        tc = int(self.type_constrain)
        for index in range(self.test_total):
            L.getHeadBatch(_addr(self._h), _addr(self._t), _addr(self._r))
            scores = np.ascontiguousarray(
                score_fn(self._h, self._t[:1], self._r[:1], "head_batch"),
                dtype=np.float32,
            )
            L.testHead(_addr(scores), index, tc)
            L.getTailBatch(_addr(self._h), _addr(self._t), _addr(self._r))
            scores = np.ascontiguousarray(
                score_fn(self._h[:1], self._t, self._r[:1], "tail_batch"),
                dtype=np.float32,
            )
            L.testTail(_addr(scores), index, tc)
        L.test_link_prediction(tc)
        return dict(
            mrr=L.getTestLinkMRR(tc), mr=L.getTestLinkMR(tc),
            hit10=L.getTestLinkHit10(tc), hit3=L.getTestLinkHit3(tc),
            hit1=L.getTestLinkHit1(tc),
        )

    def classification_batch(self):
        L = self.klib.lib
        n = self.test_total
        pos = [np.zeros(n, np.int64) for _ in range(3)]
        neg = [np.zeros(n, np.int64) for _ in range(3)]
        L.getTestBatch(*[_addr(a) for a in pos + neg])
        return pos, neg
