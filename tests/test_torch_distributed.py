"""The port's parallel layouts across processes: a 4-rank gloo group over
a (2, 2) ("data", "model") mesh on the CPU — the counterpart of
``tests/test_distributed.py``'s 8 forced host devices. One group runs
every case of ``tests/_torch_dist_cases.py`` in turn (ranks started from a
``FileStore`` under ``tmp_path``, never a fixed port); each test reads its
case's result. Inputs are made here from a numpy seed.

Bars (the JAX test's and ROADMAP's "MX ties"): sharded training equals
unsharded within 1e-4 (loss) and 5e-3 (params), for dense (accum 2,
sequence parallel over "model"), for the MoE with its experts over
"model" and for Mamba2 with a tied table split over "data" only; the dense loss also equals the JAX package's unsharded step on
the same params within 1e-4. Sharded serving gives the unsharded tokens
(dense, quantization off; Griffin and Mamba2; a packed RTN tree on the
fused backend, whose kernel calls all take the replicated route), and
under mxfp4 activations logits within 1e-2 of max |logit| and the same
tokens. Checkpoints move between meshes bit for bit. ``launch.train
--distributed`` runs over 2 CPU ranks.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
HELPER = REPO / "tests" / "_torch_dist_cases.py"
CASES = ("train", "train_moe", "train_ssm", "serve", "serve_mx", "serve_fused",
         "serve_hybrid", "serve_ssm", "elastic", "init_memory")


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")


def _np_params(tree, rng):
    """Numpy leaves for an abstract tree: norms 1, the rest N(0, 0.05^2)."""
    out = {}

    def walk(t, prefix, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/", k)
            return
        shape = tuple(t.shape)
        if name.startswith("ln") or name == "norm":
            out[prefix[:-1]] = np.ones(shape, np.float32)
        else:
            out[prefix[:-1]] = (rng.standard_normal(shape) * 0.05).astype(
                np.float32)
    walk(tree, "", "")
    return out


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parts, last = k.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run every case once in one 4-rank group; {case: result}."""
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_dist_cases as cases
    from repro_torch.launch import steps
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    flats = {}
    for tag, make in cases.CONFIGS.items():
        cfg = make()
        flats[tag] = _np_params(steps.abstract_params(cfg), rng)
        np.savez(d / f"params_{tag}.npz", **flats[tag])
        np.savez(d / f"batch_{tag}.npz",
                 inputs=rng.integers(0, cfg.vocab_size, (8, 32)),
                 labels=rng.integers(0, cfg.vocab_size, (8, 32)))
    import jax.numpy as jnp
    from repro.training import checkpoint as jckpt
    jckpt.save(d / "jax_ckpt", 7, _nest({k: jnp.asarray(v) for k, v in
                                         flats["dense"].items()}))
    procs = [subprocess.Popen(
        [sys.executable, str(HELPER), ",".join(CASES), str(r), "4", str(d)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=480)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs[0][-3000:]
    out = {}
    for c in CASES:
        res = json.loads((d / f"result_{c}.json").read_text())
        assert "error" not in res, res["error"]
        out[c] = res
    out["dir"] = d
    return out


def test_sharded_training_equals_unsharded(group):
    res = group["train"]
    assert res["dl"] < 1e-4 and res["dp"] < 5e-3, res
    # the gradients themselves (one Adam step hides their scale)
    assert res["dg_rel"] < 1e-4, res["dg_rel"]
    assert res["placements_kept"]
    # FSDP over data x TP over model: a column weight is split both ways
    assert res["layouts"]["blocks/wq"] == ["S1", "S2"]


def test_sharded_ssm_training_equals_unsharded(group):
    """Mamba2 (reduced, the vocab odd so the tied table is split over
    "data" only) under the same bars as the dense case: the head's and the
    lookup's gradients of the table sum in the table's layout."""
    res = group["train_ssm"]
    assert res["dl"] < 1e-4 and res["dp"] < 5e-3, res
    assert res["dg_rel"] < 1e-4, res["dg_rel"]
    assert res["placements_kept"]
    assert res["layouts"]["embed"] == ["S1", "R"]


def test_sharded_training_equals_the_jax_step(group):
    """The port's sharded loss against the JAX package's unsharded step on
    the same numpy params and batch."""
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.launch import steps as jsteps
    from repro.training import optimizer as jopt
    d = group["dir"]
    jcfg = ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                      attn_chunk=64)
    with np.load(d / "params_dense.npz") as z:
        params = _nest({k: jnp.asarray(z[k]) for k in z.files})
    with np.load(d / "batch_dense.npz") as z:
        batch = {k: jnp.asarray(z[k], jnp.int32) for k in z.files}
    step = jsteps.make_train_step(jcfg, jopt.AdamWConfig(lr=1e-3), accum=2)
    _, _, loss, _ = step(params, jopt.init_state(params), batch)
    assert abs(float(loss) - group["train"]["loss"]) < 1e-4


def test_moe_expert_parallel_training(group):
    res = group["train_moe"]
    assert res["dl"] < 1e-4 and res["dp"] < 5e-3, res
    assert res["dg_rel"] < 1e-4, res["dg_rel"]
    # E = 6 experts split over the model axis (expert parallel)
    assert res["layouts"]["blocks/eg"] == ["S2", "S1"]


@pytest.mark.parametrize("case", ["serve", "serve_hybrid", "serve_ssm"])
def test_sharded_serve_tokens_equal(group, case):
    res = group[case]
    assert res["tokens_equal"], res
    assert res["logit_rel"] < 1e-5, res


def test_sharded_serve_under_mx_activations(group):
    res = group["serve_mx"]
    assert res["logit_rel"] < 1e-2, res
    assert res["tokens_equal"], res


def test_kernel_wrappers_take_the_replicated_route(group):
    """Under the mesh every packed-GEMM and flash-decode call runs on
    whole local tensors (``local_map``), as many as without the mesh."""
    res = group["serve_fused"]
    assert res["tokens_equal"], res
    plain, mesh = res["paths"], res["paths_mesh"]
    fused = sum(v for k, v in plain.items() if k.split("/")[1] == "fused")
    assert mesh["mx_gemm_packed/replicated/"] == fused
    steps_n, layers = 5, 2
    assert mesh["mx_flash_decode/replicated/"] == steps_n * layers
    assert {k: v for k, v in mesh.items() if "replicated" not in k} == plain


@pytest.mark.parametrize("key", ["jax_to_mesh", "port_to_mesh",
                                 "mesh_to_plain", "trainer_mesh_ckpt_whole",
                                 "plain_ckpt_to_mesh"])
def test_elastic_checkpoint(group, key):
    assert group["elastic"][key] is True


def test_trainer_with_and_without_a_mesh(group):
    res = group["elastic"]
    assert res["loss_rel"] < 1e-5, res["losses"]


def test_trainer_init_memory_stays_near_the_shards(group):
    """Under the mesh no rank holds the whole tree while the trainer
    starts: its peak is its shards of the parameters and moments plus the
    leaf being drawn (a stacked leaf lives twice, as its layers and
    stacked, in f32 at most) — not the whole parameters and moments."""
    res = group["init_memory"]
    assert res["all_dtensors"]
    assert res["peak"] <= res["shards"] + 3 * res["largest_f32"], res
    assert res["peak"] < res["whole"], res


def test_train_cli_distributed(tmp_path):
    """``launch.train --distributed`` over 2 CPU ranks (a (2, 1) mesh,
    data-parallel as the JAX CLI trains) through ``--coordinator``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-0.5b", "--reduced", "--steps", "2", "--batch", "4",
           "--seq", "32", "--ckpt-every", "2", "--ckpt-dir",
           str(tmp_path / "ck"), "--device", "cpu", "--distributed",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
    assert "final eval ppl" in outs[0][0]
    assert "final eval ppl" not in outs[1][0]
    assert (tmp_path / "ck" / "step_00000002" / "manifest.json").exists()
