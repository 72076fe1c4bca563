"""The port's checkpoints against the JAX package's, on the CPU: the same
on-disk format both ways (arrays byte-equal), the trained bench checkpoint
restored as it stands, atomicity and retention, and the port's trainer
replaying an interrupted run bit for bit.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.models import api as japi
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.models import api as tapi
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_CKPT = ROOT / "experiments" / "bench_model"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_chunk=64)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _state_pair(cfg_kw, seed=0):
    """A JAX params + AdamW state after one update (so m, v and step are
    not their init), and the port's empty trees of the same structure."""
    jc = JArch(**cfg_kw)
    jp = japi.init(jax.random.PRNGKey(seed), jc)
    js = jopt.init_state(jp)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, js, _ = jax.jit(jopt.apply_updates, static_argnums=3)(
        jp, g, js, jopt.AdamWConfig())
    tc = TArch(**cfg_kw)
    tp = tapi.init(torch.Generator().manual_seed(9), tc, device="cpu")
    return {"params": jp, "opt": js}, {"params": tp,
                                       "opt": topt.init_state(tp)}


def _arrays(path):
    with np.load(path / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["tiny", "internvl2-26b"])
def test_jax_written_restores_in_the_port_and_back(tmp_path, name):
    """A JAX checkpoint (params + AdamW state; the vlm's tree has no
    embed) restores in the port byte for byte; the port saves it again in
    the same keys, shapes, dtypes and bytes, and JAX restores that."""
    kw = TINY if name == "tiny" else dict(
        vars(tconfigs.get_reduced(name)))
    jtree, ttree = _state_pair(kw)
    jckpt.save(tmp_path / "jax", 3, jtree, extra={"arch": kw["name"]})
    restored, man = tckpt.restore(tmp_path / "jax", ttree, device="cpu")
    assert man["step"] == 3 and restored["opt"].step == 1
    ja = _arrays(tmp_path / "jax" / "step_00000003")
    for k, v in _leaves(restored["params"]):
        np.testing.assert_array_equal(v.numpy(), ja[f"params/{k}"])
    for part in ("m", "v"):
        for k, v in _leaves(getattr(restored["opt"], part)):
            np.testing.assert_array_equal(v.numpy(), ja[f"opt/.{part}/{k}"])
    tckpt.save(tmp_path / "port", 3, restored, extra={"arch": kw["name"]})
    ta = _arrays(tmp_path / "port" / "step_00000003")
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].tobytes() == \
            ja[k].tobytes(), k
    jman = json.loads((tmp_path / "jax" / "step_00000003" /
                       "manifest.json").read_text())
    tman = json.loads((tmp_path / "port" / "step_00000003" /
                       "manifest.json").read_text())
    for f in ("keys", "shapes", "dtypes", "extra"):
        assert tman[f] == jman[f], f
    back, _ = jckpt.restore(tmp_path / "port", jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_bench_checkpoint_restores_as_it_stands():
    """``experiments/bench_model/step_00000250/`` (written by the JAX
    trainer) into the port's tree: every array byte-equal, the AdamW step
    250, and the restored model's logits those of the JAX package on the
    same checkpoint."""
    tc = TArch(**BENCH)
    tp = tapi.init(torch.Generator().manual_seed(0), tc, device="cpu")
    tree, man = tckpt.restore(BENCH_CKPT, {"params": tp,
                                           "opt": topt.init_state(tp)},
                              device="cpu")
    assert man["step"] == 250 and tree["opt"].step == 250
    ja = _arrays(BENCH_CKPT / "step_00000250")
    for k, v in _leaves(tree["params"]):
        assert v.numpy().tobytes() == ja[f"params/{k}"].tobytes(), k
    jc = JArch(**BENCH)
    jp = japi.init(jax.random.PRNGKey(0), jc)
    jtree, _ = jckpt.restore(BENCH_CKPT, {"params": jp, "opt": None})
    toks = np.random.default_rng(0).integers(0, 512, (2, 24))
    lj = np.asarray(jax.jit(japi.forward, static_argnums=1)(
        jtree["params"], jc, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        lt = tapi.forward(tree["params"], tc, torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-4 * np.abs(lj).max(), rtol=0)


def test_bfloat16_leaves_keep_their_bits(tmp_path):
    """bf16 leaves are stored as the JAX package stores them (two raw
    bytes, ``|V2``, "bfloat16" in the manifest) — the same bytes for the
    same values — and come back bit for bit, from either writer."""
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
         "s": torch.randn((4,), generator=g)}
    tckpt.save(tmp_path / "port", 1, t)
    jckpt.save(tmp_path / "jax", 1,
               {"w": jnp.asarray(t["w"].float().numpy(), jnp.bfloat16),
                "s": t["s"].numpy()})
    ta = _arrays(tmp_path / "port" / "step_00000001")
    ja = _arrays(tmp_path / "jax" / "step_00000001")
    assert ta["w"].dtype == ja["w"].dtype == np.dtype("V2")
    assert ta["w"].tobytes() == ja["w"].tobytes()
    for src in ("port", "jax"):
        back, man = tckpt.restore(tmp_path / src, t, device="cpu")
        assert man["dtypes"]["w"] == "bfloat16"
        assert torch.equal(back["w"].view(torch.int16),
                           t["w"].view(torch.int16))
        assert torch.equal(back["s"], t["s"])


def test_checkpoint_atomicity_and_retention(tmp_path):
    """``tests/test_training.py``'s test in the port, plus a crashed
    write: a stale temp directory is neither a step nor the latest."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,))}}
    (tmp_path / ".tmp_step_9_1").mkdir(parents=True)
    for s in [1, 2, 3, 4]:
        tckpt.save(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in pathlib.Path(tmp_path).iterdir()
                   if p.name.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert tckpt.latest_step(tmp_path) == 4
    restored, man = tckpt.restore(tmp_path, tree, device="cpu")
    assert man["step"] == 4
    assert torch.equal(restored["a"], tree["a"])
    assert tckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", tree, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(tmp_path, {"a": torch.zeros(3, 2),
                                 "b": {"c": torch.ones(4)}}, device="cpu")


def _trainer(d, log=None):
    tc = TrainConfig(steps=12, batch_size=4, seq_len=32, ckpt_every=5,
                     ckpt_dir=str(d), log_every=1,
                     opt=topt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=12))
    return Trainer(TArch(**TINY), tc, device="cpu",
                   log=log or (lambda *_: None))


def test_checkpoint_restart_exact_replay(tmp_path):
    """``test_checkpoint_restart_exact_replay`` in the port, held tighter:
    crash at step 8 (a checkpoint at 5), resume, and every loss after the
    resume and every final parameter equal the uninterrupted run's bit for
    bit."""
    a = _trainer(tmp_path / "a")
    a.train()
    b = _trainer(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure at 8"):
        b.train(fail_at=8)
    logs = []
    b2 = _trainer(tmp_path / "b", log=logs.append)
    b2.train()
    assert "[trainer] resumed from step 5" in logs
    assert b2.step == 12
    la = {m["step"]: m["loss"] for m in a.metrics}
    assert [m["step"] for m in b2.metrics] == list(range(6, 13))
    for m in b2.metrics:
        assert m["loss"] == la[m["step"]], m
    for (k, x), (_, y) in zip(_leaves(a.params), _leaves(b2.params)):
        assert torch.equal(x, y), k
    assert tckpt.latest_step(tmp_path / "b") == 12
