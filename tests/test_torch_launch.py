"""The port's entry points on the CPU: ``launch.train`` writes a checkpoint,
``launch.serve --arch ... --ckpt-dir ... --method rtn`` restores it, runs
PTQ and serves, and its tokens equal the JAX package's ``launch.serve`` on
the same checkpoint (same flags: wave scheduler, reference backend, dense
KV cache; the f32 checkpoint of a reduced Qwen2-0.5B, whose greedy tokens
sit on no MX tie here — ROADMAP Queue 3's bars would apply where one
did); ``artifacts export --ckpt-dir`` writes an artifact that both
packages' ``verify`` accept. Without ``--device cpu`` every entry point
runs on the card, or raises where there is none.
"""
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from repro.artifacts import verify_artifact as j_verify
from repro.launch import serve as jserve
from repro.serving.engine import Engine as JEngine
from repro_torch.artifacts import cli as tcli
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.training import checkpoint as tckpt

torch.set_num_threads(1)

ARCH = ["--arch", "qwen2-0.5b"]
TRAFFIC = ["--requests", "3", "--prompt-len", "16", "--max-new", "6"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    assert ttrain.main([*ARCH, "--reduced", "--steps", "4", "--batch", "4",
                        "--seq", "32", "--ckpt-dir", str(d), "--ckpt-every",
                        "2", "--device", "cpu"]) == 0
    return d


def _outputs(engine_cls):
    """Patch ``engine_cls.generate`` to keep the requests it served."""
    got = []
    gen = engine_cls.generate

    def spy(self, reqs):
        out = gen(self, reqs)
        got.extend(np.asarray(r.out).tolist() for r in out)
        return out
    return got, mock.patch.object(engine_cls, "generate", spy)


def test_train_writes_checkpoints_that_serve_as_jax_serves(ckpt_dir,
                                                           capsys):
    assert tckpt.latest_step(ckpt_dir) == 4
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        "step_00000002", "step_00000004"]
    t_out, t_spy = _outputs(TEngine)
    with t_spy:
        assert tserve.main([*ARCH, "--ckpt-dir", str(ckpt_dir), "--method",
                            "rtn", "--device", "cpu", "--backend", "ref",
                            "--kv-cache", "none", "--max-len", "38",
                            *TRAFFIC]) == 0
    out = capsys.readouterr().out
    assert "loaded checkpoint step 4" in out and '"tokens": 18' in out
    j_out, j_spy = _outputs(JEngine)
    with j_spy, mock.patch.object(sys, "argv", [
            "serve", *ARCH, "--ckpt-dir", str(ckpt_dir), "--method", "rtn",
            *TRAFFIC]):
        jserve.main()
    assert "loaded checkpoint step 4" in capsys.readouterr().out
    assert len(t_out) == len(j_out) == 3
    assert t_out == j_out


def test_export_from_the_checkpoint_verifies_in_both(ckpt_dir, tmp_path):
    out = tmp_path / "art"
    assert tcli.main(["export", *ARCH, "--ckpt-dir", str(ckpt_dir),
                      "--method", "rtn", "--calib-batches", "1", "--device",
                      "cpu", "--out", str(out)]) == 0
    assert tcli.main(["verify", str(out)]) == 0
    assert j_verify(out)["n_tensors"] > 0


def test_entry_points_default_to_the_card(tmp_path):
    """No --device: the card, or an error where there is none;
    --distributed without a group's address (torchrun's environment or
    --coordinator) is refused before anything starts, and the process
    group's helper takes the CPU only when asked for it."""
    with pytest.raises(SystemExit, match="--coordinator host:port"):
        ttrain.main([*ARCH, "--reduced", "--distributed", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "d")])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main([*ARCH, "--reduced", "--steps", "1", "--ckpt-dir",
                     str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main([*ARCH, "--method", "rtn"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.init_distributed(store=torch.distributed.HashStore(),
                                  world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "c").exists()
