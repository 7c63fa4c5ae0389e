"""The port's data tool and run scripts against the root ones.

- ``mkg_analogy_tpu_torch.tools.prepare_data`` writes, on the tiny dataset
  of tests/util.py, the files ``tools/prepare_data.py`` writes, byte for
  byte, with and without ``--img_vec`` (the RSME image gates);
- each ``mkg_analogy_tpu_torch/scripts/run_*.sh`` recipe calls the port's
  CLI with the root script's flags: every command line parses with the port
  CLI's ``build_parser()`` and gives the arguments the root one gives with
  the JAX CLI's parser.
"""

import filecmp
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mkg_analogy_tpu_torch.tools import prepare_data
from tests.util import make_tiny_dataset

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = sorted(p.name for p in (ROOT / "scripts").glob("run_*.sh"))


@pytest.mark.parametrize("img_vec", [False, True], ids=["ids", "img_vec"])
def test_prepare_data_matches_the_root_tool(tmp_path, img_vec):
    markg, mars = make_tiny_dataset(str(tmp_path / "data"), n_ent=24, n_triples=60)
    extra = []
    if img_vec:
        n_ent = len(open(os.path.join(markg, "entity2text.txt")).read().splitlines())
        vec = np.random.default_rng(0).standard_normal((n_ent, 8)).astype(np.float32)
        np.save(tmp_path / "vec.npy", vec)
        extra = ["--img_vec", str(tmp_path / "vec.npy"), "--remember_rate", "50"]
    common = ["--markg", markg, "--mars", mars, "--split", "80,10,10", "--seed", "3", *extra]
    want, got = tmp_path / "root", tmp_path / "port"
    subprocess.run([sys.executable, str(ROOT / "tools" / "prepare_data.py"), *common,
                    "--out", str(want)], check=True, capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    prepare_data.main([*common, "--out", str(got)])
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got))
    assert ("mrp.npy" in names) == img_vec and "type_constrain.txt" in names
    _, mismatch, errors = filecmp.cmpfiles(want, got, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def commands(path):
    """(module, argv) of each ``python -m`` command of a shell script, its
    continuation lines joined and ``"$@"`` dropped."""
    text = re.sub(r"\\\n", " ", path.read_text())
    out = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "-m"]:
            out.append((words[2], [w for w in words[3:] if w != "$@"]))
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_scripts_carry_the_root_recipes(name):
    import importlib

    port, root = (commands(ROOT / d / name) for d in ("mkg_analogy_tpu_torch/scripts",
                                                      "scripts"))
    assert len(port) == len(root) >= 1
    for (p_mod, p_argv), (r_mod, r_argv) in zip(port, root):
        assert r_mod.startswith("mkg_analogy_tpu.cli.")
        assert p_mod == r_mod.replace("mkg_analogy_tpu.", "mkg_analogy_tpu_torch.", 1)
        assert p_argv == r_argv
        p_args = vars(importlib.import_module(p_mod).build_parser().parse_args(p_argv))
        r_args = vars(importlib.import_module(r_mod).build_parser().parse_args(r_argv))
        # the flags the recipe sets take the same values on both parsers
        for flag in (w.lstrip("-") for w in r_argv if w.startswith("--")):
            assert p_args[flag] == r_args[flag], (name, flag)
