"""The port's own LATMiX artifact in the JAX package, and the port's
artifact CLI, on the CPU.

The port's ``latmix-lu`` artifact of the trained bench checkpoint (3
steps, T3, mxfp4) verifies and loads in the JAX package, where its logits
are the port's within 1e-2 of max |logit| (ROADMAP Queue 3, "MX ties").
The CLI exports, inspects and verifies an artifact of the default reduced
config, restores ``--ckpt-dir``'s checkpoint and runs on the card unless
asked for the CPU."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_engine_helpers import BENCH, checkpoint

from repro.artifacts import load_artifact as j_load
from repro.artifacts import verify_artifact as j_verify
from repro.configs.base import ArchConfig as JArch
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro_torch import convert
from repro_torch.artifacts import cli
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import ptq as tptq
from repro_torch.models import api as tapi

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)


def _calib():
    src = jsyn.make_source(JArch(**BENCH), 4, 64, 0)
    return [src.batch(i) for i in range(2)]


def _logits(tparams, tcfg, tqm, jparams, jcfg, jqm, toks):
    t = tapi.forward(tparams, tcfg, torch.from_numpy(toks), tqm).numpy()
    j = np.asarray(japi.forward(jparams, jcfg, jnp.asarray(toks), jqm))
    return t, j


def test_port_latmix_artifact_serves_in_jax(tmp_path):
    """The port's own latmix-lu artifact of the bench checkpoint: the JAX
    package verifies and loads it, and its logits there are the port's."""
    cfg = TArch(**BENCH)
    params = convert.params_from_numpy(checkpoint(), "cpu")
    res = tptq.apply_method("latmix-lu", params, cfg, _calib(), steps=3)
    assert len(res.history) == 3
    out = res.export(cfg, tmp_path / "port-latmix-lu")
    assert j_verify(out)["method"] == "latmix-lu"
    jp, jc, jq = j_load(out)
    tp, tc, tq = t_load(out, device="cpu")
    assert jq.t3_block == tq.t3_block == 32
    np.testing.assert_array_equal(np.asarray(jp["bhead"]),
                                  tp["bhead"].numpy())
    toks = _calib()[1]["inputs"][:2]
    t, j = _logits(tp, tc, tq, jp, jc, jq, toks)
    np.testing.assert_allclose(t, j, atol=1e-2 * np.abs(j).max())
    # the quantized model stays near the FP one it was calibrated against
    fp = tapi.forward(params, cfg, torch.from_numpy(toks)).numpy()
    assert np.corrcoef(fp.ravel(), t.ravel())[0, 1] > 0.9


def test_artifact_cli_export_inspect_verify(tmp_path, capsys):
    out = tmp_path / "cli-art"
    rc = cli.main(["export", "--device", "cpu", "--steps", "2",
                   "--calib-batches", "1", "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "random init (demo mode)" in text and "exported artifact" in text
    assert cli.main(["inspect", str(out), "--tensors"]) == 0
    text = capsys.readouterr().out
    assert "latmix-lu / mxfp4" in text and "tinyllama-1.1b-smoke" in text
    assert "blocks/bq" in text and "bhead" in text
    assert cli.main(["verify", str(out)]) == 0
    assert "hashes and roofline" in capsys.readouterr().out
    assert j_verify(out)["n_tensors"] > 0
    # a flipped byte fails verify
    w = out / "weights.npz"
    raw = bytearray(w.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    w.write_bytes(bytes(raw))
    assert cli.main(["verify", str(out)]) == 1


def test_artifact_cli_refuses_checkpoints_and_needs_the_card(tmp_path,
                                                            capsys):
    """--ckpt-dir restores the latest training checkpoint there (the
    artifact's unquantized leaves are the checkpoint's, byte for byte); an
    empty --ckpt-dir falls back to the random init and says so; with no
    --device the export runs on the card or raises."""
    from repro_torch import configs
    from repro_torch.training import checkpoint as tckpt

    cfg = configs.get_reduced("tinyllama-1.1b")
    params = tapi.init(torch.Generator().manual_seed(5), cfg, device="cpu")
    params["ln_f"] = params["ln_f"] * 1.5
    tckpt.save(tmp_path / "ck", 7, {"params": params})
    assert cli.main(["export", "--ckpt-dir", str(tmp_path / "ck"),
                     "--method", "rtn", "--calib-batches", "1", "--device",
                     "cpu", "--out", str(tmp_path / "x")]) == 0
    assert "loaded checkpoint step 7" in capsys.readouterr().out
    tp, _, _ = t_load(tmp_path / "x", device="cpu")
    np.testing.assert_array_equal(tp["ln_f"].numpy(),
                                  params["ln_f"].numpy())
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  params["embed"].numpy())
    assert cli.main(["export", "--ckpt-dir", str(tmp_path / "none"),
                     "--method", "rtn", "--calib-batches", "1", "--device",
                     "cpu", "--out", str(tmp_path / "z")]) == 0
    assert "random init (demo mode)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            cli.main(["export", "--out", str(tmp_path / "y")])
    assert pathlib.Path(tmp_path).is_dir()
