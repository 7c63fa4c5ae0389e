"""Export derived data artifacts from MarKG/MARS (the port of
``tools/prepare_data.py``, on the port's readers, OpenKE writers and image
gates; the same flags and the same files, byte for byte):

  python -m mkg_analogy_tpu_torch.tools.prepare_data --markg dataset/MarKG \
      --mars dataset/MARS --out data/analogy [--img_vec vit_vectors.npy] \
      [--split 98,1,1]

Writes: entity2id.txt relation2id.txt {train,valid,test}2id.txt
        {train,valid,test}2id_ft.txt type_constrain.txt 1-1/1-n/n-1/n-n.txt
        (+ mrp.npy rel_sig_alpha.npy rel_forget_gate.npy when --img_vec)

Host-side only: numpy, no accelerator.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.gates import build_gates
from ..data.openke_tools import write_category_splits, write_id_files, write_type_constraints
from ..data.readers import MARS, MarKG


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--markg", required=True)
    ap.add_argument("--mars", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="98,1,1",
                    help="train,valid,test percentage split of MarKG triples")
    ap.add_argument("--img_vec", default=None)
    ap.add_argument("--remember_rate", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    markg = MarKG(args.markg)
    mars = MARS(args.mars, markg)
    rng = np.random.default_rng(args.seed)

    triples = markg.triples_as_ids()  # (h, r, t)
    parts = [int(x) for x in args.split.split(",")]
    perm = rng.permutation(len(triples))
    n_va = len(triples) * parts[1] // 100
    n_te = len(triples) * parts[2] // 100
    order = [triples[i] for i in perm]
    splits = {
        "valid": order[:n_va],
        "test": order[n_va:n_va + n_te],
        "train": order[n_va + n_te:],
    }
    write_id_files(args.out, markg, mars, splits=splits)

    def as_htr(rows):
        return [(h, t, r) for h, r, t in rows]

    write_type_constraints(args.out, *[as_htr(v) for v in splits.values()])
    write_category_splits(args.out, as_htr(splits["train"]), as_htr(splits["test"]))

    if args.img_vec:
        img = np.load(args.img_vec)
        trip_lrt = np.asarray([(h, r, t) for h, r, t in triples], np.int64)
        mrp, alpha, gate = build_gates(trip_lrt, img, markg.num_relations, args.remember_rate)
        np.save(os.path.join(args.out, "mrp.npy"), mrp)
        np.save(os.path.join(args.out, "rel_sig_alpha.npy"), alpha)
        np.save(os.path.join(args.out, "rel_forget_gate.npy"), gate)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
