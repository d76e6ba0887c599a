"""The port's dry run and its multi-device training launcher, on the CPU.

* ``python -m repro_torch.launch.dryrun`` in its own process (the fake
  process group is the process's default group) on the smoke yi-6b train
  cell (2 microbatches split from the data-sharded batch, remat full) and
  the smoke mixtral-8x22b decode cell over a fake 2x4 mesh: ``status
  ok``, JAX's record keys, per-device bytes that count the local shards,
  collectives and a roofline; a cell that fails is recorded ``fail`` and
  the exit code is 1, as JAX's.
* ``train --smoke --device cpu --data-model 2 2 --steps 2`` under
  ``torchrun`` (4 gloo ranks) gives the losses of ``--data-model 1 1``.
  The smoke config is bf16 and the 2x2 mesh sums the model-sharded
  products' partial outputs in bf16, so the losses agree within 3e-3
  (about 5e-4 of their size).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
# the record of ``repro/launch/dryrun.py``'s lower_cell, key by key
JAX_KEYS = {"arch", "shape", "mesh", "chips", "status", "lower_s",
            "compile_s", "memory", "collectives", "roofline",
            "dropped_shardings"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device_bytes"}
JAX_ROOFLINE = {"flops", "hbm_bytes", "collective_bytes", "chips",
                "model_flops", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "useful_flops_fraction",
                "roofline_fraction"}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _dryrun(tmp_path, *args):
    out = tmp_path / "dr.jsonl"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--mesh", "2x4", "--smoke", "--out", str(out),
                        *args], capture_output=True, text=True, env=_env(),
                       timeout=600)
    recs = [json.loads(ln) for ln in out.read_text().splitlines()] \
        if out.exists() else []
    return r, recs


@pytest.mark.parametrize("arch, shape, extra", [
    ("yi-6b", "train_4k", ["--seq", "64", "--batch", "8",
                           "--microbatches", "2"]),
    ("mixtral-8x22b", "decode_32k", ["--seq", "64", "--batch", "8"])])
def test_dryrun_cell_on_fake_mesh(tmp_path, arch, shape, extra):
    r, recs = _dryrun(tmp_path, "--arch", arch, "--shape", shape, *extra)
    assert r.returncode == 0, r.stderr[-4000:]
    (rec,) = recs
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert set(rec) - {"cuts"} == JAX_KEYS
    assert set(rec["memory"]) == JAX_MEMORY
    assert set(rec["roofline"]) == JAX_ROOFLINE
    assert rec["cuts"]["smoke"] is True
    m, roof = rec["memory"], rec["roofline"]
    assert m["argument_bytes"] > 0 and m["temp_bytes"] > 0
    assert m["peak_per_device_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
    assert roof["model_flops"] > 0
    # the data and model shards move: every cell has collectives
    assert sum(rec["collectives"]["counts"].values()) > 0
    if shape == "train_4k":
        # params and moments are updated in place (aliased)
        assert m["alias_bytes"] > 0
        assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert re.search(rf"^OK +{re.escape(arch)} x {shape} x 2x4", r.stdout,
                     re.M)


def test_dryrun_failure_is_recorded(tmp_path):
    r, recs = _dryrun(tmp_path, "--arch", "no-such-arch", "--shape",
                      "decode_32k")
    assert r.returncode == 1
    (rec,) = recs
    assert rec["status"] == "fail" and "error" in rec
    assert "FAIL  no-such-arch x decode_32k x 2x4" in r.stdout


def _losses(text):
    return [float(m) for m in re.findall(r"^step +\d+ loss ([\d.]+)", text,
                                         re.M)]


def test_train_cli_on_a_2x2_mesh_matches_one_device(tmp_path):
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "32", "--log-every", "1"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "4"]
    mesh = subprocess.run(
        torchrun + ["-m", "repro_torch.launch.train", *args,
                    "--data-model", "2", "2",
                    "--ckpt-dir", str(tmp_path / "mesh")],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert mesh.returncode == 0, mesh.stderr[-4000:]
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "one")],
        capture_output=True, text=True, env=_env(), timeout=600)
    assert one.returncode == 0, one.stderr[-4000:]
    got, want = _losses(mesh.stdout), _losses(one.stdout)
    assert len(got) == len(want) == 2     # rank 0 alone prints
    for g, w in zip(got, want):
        assert abs(g - w) <= 3e-3, (got, want)
    assert "done: 2 steps" in mesh.stdout
