"""Shared pieces of the port's contiguous-layout engine tests
(``test_torch_engine_contiguous.py`` and
``test_torch_engine_contiguous_artifact.py``): the trained bench
checkpoint, the traffic and the schedule comparison."""
import pathlib

import jax.numpy as jnp
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "experiments" / "bench_model" / "step_00000250" / "arrays.npz"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
COUNTERS = ("admitted", "decode_steps", "slot_steps", "prefill_chunk_steps",
            "prefill_lane_steps", "prefill_batched_steps",
            "prefix_hit_tokens", "useful_decode_tokens")


def checkpoint():
    """The trained bench model as a nested dict of numpy leaves."""
    with np.load(CKPT) as z:
        flat = {k[len("params/"):]: z[k] for k in z.files
                if k.startswith("params/")}
    tree = {"blocks": {}}
    for key, v in flat.items():
        if key.startswith("blocks/"):
            tree["blocks"][key[len("blocks/"):]] = v
        else:
            tree[key] = v
    return tree


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def ragged_traffic():
    """Five requests over four lanes: ragged prompt lengths (one longer
    than a chunk), so most lanes carry left pads under both schedulers,
    and budgets that end at different steps."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 512, t).astype(np.int32), m)
            for t, m in zip((20, 70, 5, 130, 33), (12, 9, 12, 40, 1))]


def flat_traffic():
    """Five requests of one chunk each (64 tokens) over four lanes: no
    lane carries a pad under either scheduler, bucketed or not."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 512, 64).astype(np.int32), m)
            for m in (12, 9, 12, 40, 1)]


def serve(eng, Request, traffic=ragged_traffic):
    reqs = [Request(prompt=p, max_new=m) for p, m in traffic()]
    eng.generate(reqs)
    return reqs


def same_schedule(teng, treqs, jeng, jreqs):
    for a, b in zip(treqs, jreqs):
        assert a.state.value == b.state.value == "finished"
        assert len(a.out) == len(b.out)
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


CONTIGUOUS_CASES = [
    dict(scheduler=s, bucket_prompts=b, kv_cache=kv)
    for s, b in (("wave", True), ("wave", False), ("continuous", True))
    for kv in ("none", "mxfp8")]


def case_id(c):
    return "-".join(str(c[k]) for k in ("scheduler", "bucket_prompts",
                                        "kv_cache"))
