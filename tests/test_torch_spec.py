"""Seeded sampling and speculative decoding in the port's engine against
the JAX package.

- ``verify`` / ``verify_paged`` give ``repro.models.api``'s logits within
  1e-4 of max |logit| on a small f32 model, and within 1e-2 (the bar of
  ROADMAP Queue 3) on the mxfp4 bench artifact; idle lanes write nothing.
- On the small f32 model of ``tests/test_sampling.py`` the port's engine
  gives the JAX engine's tokens for sampled requests on all three serving
  paths, and for speculative decoding (k = 3) on both continuous layouts.
- Speculative greedy tokens equal non-speculative greedy tokens, and
  temperature 0 equals greedy bitwise under both backends.
- The port's versions of the JAX package's rollback, EOS / budget and
  validation tests, and one seeded chi-squared check that spec sampling
  keeps the non-spec distribution.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.artifacts import export_artifact as j_export
from repro.artifacts import load_artifact as j_load
from repro.configs.base import ArchConfig as JArch
from repro.core import ptq as jptq
from repro.core.quantize import KVCacheQuant as JKV
from repro.core.quantize import QuantMode as JQM
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.policy import SpecConfig as JSpec
from repro.serving.sampling import SamplingParams as JSP
from repro_torch import convert
from repro_torch.artifacts import load_artifact as t_load
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.quantize import QuantMode as TQM
from repro_torch.kernels.packing import PackedKV, PagedKV
from repro_torch.models import api as tapi
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.policy import RequestState, SpecConfig as TSpec
from repro_torch.serving.sampling import SamplingParams as TSP

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "experiments" / "bench_model" / "step_00000250" / "arrays.npz"
BENCH = dict(name="bench-llama", family="dense", n_layers=4, d_model=128,
             n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
             attn_chunk=64)
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, attn_chunk=16)
COMBOS = [("wave", "contiguous"), ("continuous", "contiguous"),
          ("continuous", "paged")]
SAMPLED = dict(temperature=0.9, top_k=12, top_p=0.9)
COUNTERS = ("admitted", "decode_steps", "slot_steps", "useful_decode_tokens",
            "prefill_chunk_steps", "spec_proposed_tokens",
            "spec_accepted_tokens")
slow = pytest.mark.slow


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's small f32 model (``tests/test_sampling.py``) in
    both packages."""
    jp = japi.init(jax.random.PRNGKey(0), JArch(**TINY))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _eng_kw(layout):
    kw = dict(batch_size=2, max_len=64, kv_layout=layout)
    if layout == "paged":
        kw.update(page_size=32, n_pages=8)
    return kw


def _reqs(Req, SP, lens, news, seed=0, sampling=None):
    rng = np.random.default_rng(seed)
    return [Req(prompt=rng.integers(0, TINY["vocab_size"], s)
                .astype(np.int32), max_new=n,
                sampling=(SP(**dict(sampling, seed=i))
                          if sampling is not None else None))
            for i, (s, n) in enumerate(zip(lens, news))]


def _rep_reqs(Req, SP, n, seed=0, period=3, prompt_len=12, max_new=24,
              sampling=None):
    """Repetition-friendly prompts (tiled random motifs) so the
    prompt-lookup drafter has something to accept."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        motif = rng.integers(0, TINY["vocab_size"], period)
        prompt = np.tile(motif, prompt_len // period + 1)[:prompt_len]
        reqs.append(Req(prompt=prompt.astype(np.int32), max_new=max_new,
                        sampling=(SP(**dict(sampling, seed=i))
                                  if sampling is not None else None)))
    return reqs


def _mixed_traffic(Req, SP):
    """Repetitive greedy and sampled requests beside incompressible
    sampled ones."""
    return (_rep_reqs(Req, SP, 2, seed=23)
            + _rep_reqs(Req, SP, 2, seed=25, max_new=16, sampling=SAMPLED)
            + _reqs(Req, SP, [11, 17], [10, 12], seed=24, sampling=SAMPLED))


def _jax_engine(jp, **kw):
    return JEngine(jp, JArch(**TINY), JQM.off(), **kw)


def _port_engine(tp, **kw):
    return TEngine(tp, TArch(**TINY), TQM.off(), device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """The JAX engine's tokens and counters, once per module: sampled
    traffic on the three paths, mixed traffic under spec (k = 3) on the
    two continuous layouts."""
    jp = tiny[0]
    out = {}
    for sched, layout in COMBOS:
        reqs = _reqs(JRequest, JSP, [9, 21, 14, 6], [6, 5, 8, 4], seed=11,
                     sampling=SAMPLED)
        reqs[2].sampling = None                       # a greedy lane
        _jax_engine(jp, scheduler=sched, **_eng_kw(layout)).generate(reqs)
        out[sched, layout] = [r.out for r in reqs]
    for layout in ("contiguous", "paged"):
        eng = _jax_engine(jp, scheduler="continuous", spec=JSpec(k=3),
                          **_eng_kw(layout))
        reqs = _mixed_traffic(JRequest, JSP)
        eng.generate(reqs)
        st = eng.stats()
        out["spec", layout] = ([r.out for r in reqs],
                               {k: st[k] for k in COUNTERS})
    return out


# ---------------------------------------------------------------------------
# Model: verify steps
# ---------------------------------------------------------------------------

def _jax_fill(params, cfg, qm, cache, toks, tables):
    """Chunk-prefill ``toks`` (B, n * chunk) into a JAX cache at 0."""
    C = cfg.attn_chunk
    for ci in range(toks.shape[1] // C):
        chunk = jnp.asarray(toks[:, ci * C:(ci + 1) * C])
        if tables is not None:
            _, cache = japi.prefill_chunk_paged(params, cfg, cache, tables,
                                                chunk, ci * C, C - 1, qm)
        else:
            _, cache = japi.prefill_chunk(params, cfg, cache, chunk, ci * C,
                                          C - 1, qm)
    return cache


def _port_cache(jcache):
    """The port's copy of a JAX cache, byte for byte."""
    def leaf(a):
        if isinstance(a, jnp.ndarray):
            return torch.from_numpy(np.array(a))
        cls = PagedKV if hasattr(a, "page_size") else PackedKV
        return cls(torch.from_numpy(np.array(a.codes)),
                   None if a.scales is None
                   else torch.from_numpy(np.array(a.scales)),
                   a.fmt, str(a.dtype))
    return {k: leaf(v) for k, v in jcache.items()}


def _verify_both(jside, tside, arch, kv, layout, n_fill):
    """The same cache (the JAX package's prefill, its bytes copied into the
    port's cache, so that verify alone is compared), then one verify step
    of C = 4 slots over
    three lanes: a full lane, a lane rewound into its own prefix with two
    valid slots, and an idle lane (n_valid 0). Returns the two packages'
    logits (B, C, V) and the idle lane's cache rows before and after."""
    (jp, jqm), (tp, tqm) = jside, tside
    jc, tc = JArch(**arch), TArch(**arch)
    B, C, S = 3, 4, 4 * arch["attn_chunk"]
    rng = np.random.default_rng(8)
    fill = rng.integers(0, arch["vocab_size"], (B, n_fill)).astype(np.int32)
    inp = rng.integers(0, arch["vocab_size"], (B, C)).astype(np.int32)
    pos = np.array([n_fill, n_fill - 7, 0], np.int32)
    nv = np.array([C, 2, 0], np.int32)
    paged = layout == "paged"
    if paged:
        P = arch["attn_chunk"] * max(1, 64 // arch["attn_chunk"])
        maxp = -(-S // P)
        tables = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp)
        tables[2] = 0
        jcache = japi.init_cache_paged(jc, 1 + B * maxp, P,
                                       kv_quant=JKV.parse(kv))
    else:
        tables = None
        jcache = japi.init_cache(jc, B, S, kv_quant=JKV.parse(kv))
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else torch.from_numpy(tables)
    jcache = _jax_fill(jp, jc, jqm, jcache, fill, jt)
    tcache = _port_cache(jcache)

    def idle_rows():
        leaf = tcache["k"]
        codes = leaf if isinstance(leaf, torch.Tensor) else leaf.codes
        return codes[:, 0].clone() if paged else codes[:, 2].clone()

    before = idle_rows()
    args = (jnp.asarray(inp), jnp.asarray(pos), jnp.asarray(nv))
    targs = (torch.from_numpy(inp), torch.from_numpy(pos),
             torch.from_numpy(nv))
    if paged:
        jl, _ = japi.verify_paged(jp, jc, jcache, *args, jt, jqm)
        tl, tcache = tapi.verify_paged(tp, tc, tcache, *targs, tt, tqm)
    else:
        jl, _ = japi.verify(jp, jc, jcache, *args, jqm)
        tl, tcache = tapi.verify(tp, tc, tcache, *targs, tqm)
    return np.asarray(jl), tl.numpy(), before, idle_rows()


@pytest.mark.parametrize("kv", ("none", "mxfp8"))
@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_verify_matches_jax_f32(tiny, layout, kv):
    """Small f32 model: logits within 1e-4 of max |logit|; the idle lane
    (paged: the scrap page) is left as it was."""
    jp, tp = tiny
    jl, tl, before, after = _verify_both(
        (jp, JQM.off()), (tp, TQM.off().with_backend("fused")), TINY, kv,
        layout, n_fill=32)
    assert jl.shape == tl.shape == (3, 4, TINY["vocab_size"])
    assert np.abs(jl - tl).max() <= 1e-4 * np.abs(jl).max()
    assert torch.equal(before, after)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The bench checkpoint, RTN mxfp4 by the JAX package with T3, exported
    by the JAX package."""
    with np.load(CKPT) as z:
        flat = {k[len("params/"):]: jnp.asarray(z[k]) for k in z.files
                if k.startswith("params/")}
    params = {"blocks": {}}
    for key, v in flat.items():
        if key.startswith("blocks/"):
            params["blocks"][key[len("blocks/"):]] = v
        else:
            params[key] = v
    res = jptq.apply_method("rtn", params, JArch(**BENCH), calib=[])
    res.qm = dataclasses.replace(res.qm, t3_block=32)
    out = tmp_path_factory.mktemp("spec") / "bench-mxfp4"
    j_export(res, JArch(**BENCH), out)
    return out


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_verify_matches_jax_on_the_mxfp4_artifact(artifact, layout):
    """The mxfp4 bench artifact (MX weights and activations, T3), mxfp8
    KV: the port's fused path against the JAX reference path within 1e-2
    of max |logit| (ROADMAP Queue 3's bar: MX snaps on ulp ties)."""
    jp, _, jqm = j_load(artifact)
    tp, _, tqm = t_load(artifact, device="cpu")
    jl, tl, before, after = _verify_both(
        (jp, jqm.with_backend("ref")), (tp, tqm.with_backend("fused")),
        BENCH, "mxfp8", layout, n_fill=128)
    assert np.abs(jl - tl).max() <= 1e-2 * np.abs(jl).max()
    assert torch.equal(before, after)


# ---------------------------------------------------------------------------
# Engine: tokens against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler,layout", COMBOS)
def test_sampled_tokens_match_jax_engine(tiny, jax_runs, scheduler, layout):
    """Sampled requests (temperature 0.9, top-k 12, top-p 0.9, seeds 0-3)
    with one greedy request among them: the JAX engine's tokens."""
    reqs = _reqs(TRequest, TSP, [9, 21, 14, 6], [6, 5, 8, 4], seed=11,
                 sampling=SAMPLED)
    reqs[2].sampling = None
    _port_engine(tiny[1], scheduler=scheduler,
                 **_eng_kw(layout)).generate(reqs)
    for a, b in zip(reqs, jax_runs[scheduler, layout]):
        assert a.state is RequestState.FINISHED
        np.testing.assert_array_equal(a.out, b)


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_spec_tokens_and_counters_match_jax_engine(tiny, jax_runs, layout):
    """Spec decoding at k = 3 on mixed greedy / sampled traffic: the JAX
    engine's tokens, and its proposed and accepted counts."""
    eng = _port_engine(tiny[1], scheduler="continuous", spec=TSpec(k=3),
                       **_eng_kw(layout))
    reqs = _mixed_traffic(TRequest, TSP)
    eng.generate(reqs)
    want, counters = jax_runs["spec", layout]
    for a, b in zip(reqs, want):
        np.testing.assert_array_equal(a.out, b)
    st = eng.stats()
    assert {k: st[k] for k in COUNTERS} == counters
    assert counters["spec_accepted_tokens"] > 0
    assert st["spec_acceptance"] == (counters["spec_accepted_tokens"]
                                     / counters["spec_proposed_tokens"])


@pytest.mark.parametrize("layout", ("contiguous", "paged"))
def test_spec_greedy_equals_nonspec_greedy(tiny, layout):
    """QuantMode.off(): speculative decoding changes how many forwards
    produce the tokens, never the tokens (verify runs C = 4 rows a lane
    through the GEMMs and attention where decode runs one)."""
    outs = {}
    for spec in (None, TSpec(k=3)):
        eng = _port_engine(tiny[1], scheduler="continuous", spec=spec,
                           **_eng_kw(layout))
        reqs = (_rep_reqs(TRequest, TSP, 3, seed=23)
                + _reqs(TRequest, TSP, [11, 17], [10, 12], seed=24))
        eng.generate(reqs)
        outs[spec is None] = [r.out for r in reqs]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
    assert eng.stats()["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("backend", ("ref", "fused"))
@pytest.mark.parametrize("scheduler,layout", COMBOS)
def test_temperature_zero_equals_greedy(tiny, scheduler, layout, backend):
    """A SamplingParams of temperature 0 (whatever its other knobs) gives
    the tokens of a request with no sampling, beside a sampled request
    that sends the batch through the sampler; an mxfp8 cache."""
    outs = {}
    for tag, sp in (("greedy", None),
                    ("temp0", dict(temperature=0.0, top_k=5, top_p=0.5))):
        eng = _port_engine(tiny[1], scheduler=scheduler, backend=backend,
                           kv_cache="mxfp8", **_eng_kw(layout))
        reqs = _reqs(TRequest, TSP, [9, 21, 14, 6], [6, 5, 8, 4], seed=11,
                     sampling=sp)
        reqs[3].sampling = TSP(**SAMPLED)
        eng.generate(reqs)
        outs[tag] = [r.out for r in reqs[:3]]
    for g, t in zip(outs["greedy"], outs["temp0"]):
        np.testing.assert_array_equal(g, t)


# ---------------------------------------------------------------------------
# Rollback, EOS / budget, validation
# ---------------------------------------------------------------------------

def test_spec_rollback_allocator_invariants(tiny):
    """Mixed accept / reject traffic (repetitive and incompressible
    prompts, greedy and sampled lanes) keeps the page accounting
    partitioned after every engine step and drains with no page in use."""
    eng = _port_engine(tiny[1], scheduler="continuous", batch_size=2,
                       max_len=64, kv_layout="paged", page_size=32,
                       n_pages=8, spec=TSpec(k=4))
    sp = dict(temperature=0.8, top_k=12)
    reqs = (_rep_reqs(TRequest, TSP, 3, seed=31, max_new=20)
            + _reqs(TRequest, TSP, [13, 26, 9], [12, 8, 15], seed=32,
                    sampling=sp)
            + _rep_reqs(TRequest, TSP, 2, seed=33, max_new=10, sampling=sp))
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
        assert steps < 400, "spec run failed to drain"
        acct = eng._alloc.check()
        assert (acct["in_use"] + acct["free"] + acct["cached"]
                == eng._alloc.capacity)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert all(len(r.out) == r.max_new for r in reqs)
    assert eng._alloc.in_use == 0
    assert eng.stats()["spec_proposed_tokens"] > 0


def test_spec_respects_eos_and_budget(tiny):
    """Accepted drafts past the first EOS are dropped; a lane never emits
    more than its budget even when every draft lands."""
    eng = _port_engine(tiny[1], scheduler="continuous", eos_id=0,
                       spec=TSpec(k=4), **_eng_kw("paged"))
    done = eng.generate(_rep_reqs(TRequest, TSP, 4, seed=37, max_new=11))
    for r in done:
        assert len(r.out) <= 11
        hits = np.flatnonzero(np.asarray(r.out) == 0)
        if hits.size:
            assert hits[0] == len(r.out) - 1


def test_spec_requires_continuous_scheduler(tiny):
    with pytest.raises(ValueError, match="continuous"):
        _port_engine(tiny[1], scheduler="wave", spec=TSpec(k=2),
                     batch_size=2, max_len=64)


def test_spec_config_validation():
    for bad in (dict(k=0), dict(ngram_min=3, ngram_max=2),
                dict(ngram_min=0)):
        with pytest.raises(ValueError):
            TSpec(**bad)


def test_serve_entry_point_samples_and_speculates(artifact, capsys):
    """``launch/serve.py`` on the CPU with the sampling and spec flags:
    ``--spec-k`` forces the continuous scheduler; a rerun replays."""
    import json

    from repro_torch.launch import serve
    argv = ["--artifact", str(artifact), "--device", "cpu", "--requests",
            "2", "--prompt-len", "24", "--max-new", "6", "--temperature",
            "0.8", "--top-k", "40", "--top-p", "0.95", "--sample-seed", "3",
            "--spec-k", "3", "--kv-layout", "paged"]
    assert serve.main(argv) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["scheduler"] == "continuous" and res["tokens"] == 12
    assert res["spec_proposed_tokens"] >= 0
    assert 0.0 <= res["spec_acceptance"] <= 1.0


# ---------------------------------------------------------------------------
# Distribution
# ---------------------------------------------------------------------------

def _chi2_crit(df: int, z: float = 3.0902) -> float:
    """Upper critical value of chi2(df) at alpha ~= 1e-3 (Wilson-Hilferty,
    as in tests/test_sampling.py)."""
    c = 2.0 / (9.0 * df)
    return df * (1.0 - c + z * np.sqrt(c)) ** 3


def _two_sample_chi2(c1, c2, min_bin=8):
    c1 = np.asarray(c1, np.float64)
    c2 = np.asarray(c2, np.float64)
    big = (c1 + c2) >= min_bin
    o1 = np.append(c1[big], c1[~big].sum())
    o2 = np.append(c2[big], c2[~big].sum())
    use = (o1 + o2) > 0
    o1, o2 = o1[use], o2[use]
    n1, n2 = o1.sum(), o2.sum()
    p = (o1 + o2) / (n1 + n2)
    stat = float((((o1 - n1 * p) ** 2) / (n1 * p)).sum()
                 + (((o2 - n2 * p) ** 2) / (n2 * p)).sum())
    return stat, len(o1) - 1


@slow
def test_spec_sampled_frequency_matches_nonspec(tiny):
    """Pooled token histograms of spec and non-spec runs at the same
    SamplingParams pass a two-sample chi-squared (alpha 1e-3): the tokens
    differ (acceptance consumes other uniforms), the distribution must
    not."""
    sp = dict(temperature=1.0, top_k=8)
    counts = {}
    for tag, spec in (("off", None), ("on", TSpec(k=3))):
        eng = _port_engine(tiny[1], scheduler="continuous", spec=spec,
                           **_eng_kw("paged"))
        reqs = _rep_reqs(TRequest, TSP, 40, seed=29, max_new=16,
                         sampling=sp)
        eng.generate(reqs)
        toks = np.concatenate([np.asarray(r.out) for r in reqs])
        counts[tag] = np.bincount(toks, minlength=TINY["vocab_size"])
        if spec is not None:
            assert eng.stats()["spec_accepted_tokens"] > 0
    stat, df = _two_sample_chi2(counts["off"], counts["on"])
    assert stat < _chi2_crit(df), (stat, df)
