"""The port's sampling module against ``repro.serving.sampling``: the
threefry keys, random bits and uniforms equal ``jax.random``'s bitwise; the
gumbel noise is within 4 float32 ulps of 16 of jax's (the two ``log``s may
part in the last bit); ``sample_tokens`` and ``spec_accept`` give the JAX
package's tokens on the same logits, over temperatures, top-k, top-p and
draft counts; ``propose_ngram`` is the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as js
from repro_torch.serving import sampling as ts

# one PyTorch thread per process: the suite runs in several worker
# processes at once, and a thread per core in each starves them all
torch.set_num_threads(1)

NOISE_BAR = 4 * 2.0 ** -20      # 4 ulps of float32 at 16 (gumbel's top)


def _triples(n, seed):
    """n (seed, step, channel) triples: seeds over all of uint32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 1 << 20, n).astype(np.int32),
            rng.integers(0, 2, n).astype(np.int32))


def _tkey(seeds, steps, chans):
    return ts._key(torch.from_numpy(seeds.astype(np.int64)),
                   torch.from_numpy(steps.astype(np.int64)),
                   torch.from_numpy(chans.astype(np.int64)))


def test_keys_bits_and_uniforms_equal_jax_bitwise():
    seeds, steps, chans = _triples(4096, 0)
    seeds[:4] = (0, 1, 2 ** 31, 2 ** 32 - 1)
    steps[:4] = 0
    jk = np.asarray(jax.jit(jax.vmap(js._key))(
        jnp.asarray(seeds), jnp.asarray(steps), jnp.asarray(chans)))
    tk = _tkey(seeds, steps, chans)
    np.testing.assert_array_equal(jk[:, 0].astype(np.int64), tk[0].numpy())
    np.testing.assert_array_equal(jk[:, 1].astype(np.int64), tk[1].numpy())
    keys = jnp.asarray(jk)
    for shape in ((), (37,)):
        jb = np.asarray(jax.jit(jax.vmap(
            lambda k: jax.random.bits(k, shape)))(keys)).astype(np.int64)
        np.testing.assert_array_equal(
            jb, ts.random_bits(tk, shape[0] if shape else None).numpy())
    ju = np.asarray(jax.jit(jax.vmap(jax.random.uniform))(keys))
    np.testing.assert_array_equal(ju.view(np.int32),
                                  ts.uniform(tk).numpy().view(np.int32))


def test_gumbel_noise_within_ulps_of_jax():
    seeds, steps, chans = _triples(256, 1)
    jk = jnp.asarray(np.stack([np.zeros_like(seeds), seeds], 1))
    jg = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.gumbel(k, (512,))))(jk))
    tg = ts.gumbel(ts.prng_key(torch.from_numpy(seeds.astype(np.int64))),
                   512).numpy()
    assert np.abs(jg - tg).max() <= NOISE_BAR


def _logits(B, V, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((B, V)) * scale).astype(np.float32)
    lg[0, 5] = lg[0, 9] = lg[0].max() + 1.0       # a tie at the top
    return lg


SAMPLE_CASES = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 20, 1.0),
                (1.3, 0, 0.8), (0.8, 50, 0.95), (1.0, 1, 0.5),
                (0.5, 0, 0.05)]


@pytest.mark.parametrize("temp,top_k,top_p", SAMPLE_CASES)
def test_sample_tokens_match_jax(temp, top_k, top_p):
    """64 lanes over a vocabulary of 512: per-lane seeds and emission
    indices, lane 1 greedy inside a sampled batch."""
    B, V = 64, 512
    lg = _logits(B, V, 3)
    rng = np.random.default_rng(4)
    temps = np.full(B, temp, np.float32)
    temps[1] = 0.0
    tks = np.full(B, top_k, np.int32)
    tps = np.full(B, top_p, np.float32)
    seeds = rng.integers(0, 2 ** 31, B).astype(np.uint32)
    steps = rng.integers(0, 4096, B).astype(np.int32)
    j = np.asarray(jax.jit(js.sample_tokens)(
        jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(tks),
        jnp.asarray(tps), jnp.asarray(seeds), jnp.asarray(steps)))
    t = ts.sample_tokens(torch.from_numpy(lg), torch.from_numpy(temps),
                         torch.from_numpy(tks.astype(np.int64)),
                         torch.from_numpy(tps),
                         torch.from_numpy(seeds.astype(np.int64)),
                         torch.from_numpy(steps.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy(), j)
    assert t[1] == lg[1].argmax()


SPEC_CASES = [(0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 12, 0.9), (1.2, 0, 0.7)]


@pytest.mark.parametrize("K", (0, 3, 4))
@pytest.mark.parametrize("temp,top_k,top_p", SPEC_CASES)
def test_spec_accept_matches_jax(temp, top_k, top_p, K):
    """B lanes of C = K + 1 slots: draft counts from 0 to K (and an idle
    lane at -1), lanes whose drafts are every slot's argmax on peaked
    logits (full acceptance) and lanes of random drafts (rejections)."""
    B, V = 24, 256
    C = K + 1
    rng = np.random.default_rng(5 + K)
    lg = (rng.standard_normal((B, C, V)) * 2.0).astype(np.float32)
    lg[:8] *= 6.0                                   # peaked: drafts land
    am = lg.argmax(-1)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    drafts[:8] = am[:8, :K]
    n_drafts = rng.integers(0, K + 1, B).astype(np.int32)
    n_drafts[:4] = K
    n_drafts[-1] = -1
    temps = np.full(B, temp, np.float32)
    tks = np.full(B, top_k, np.int32)
    tps = np.full(B, top_p, np.float32)
    seeds = rng.integers(0, 2 ** 31, B).astype(np.uint32)
    steps = rng.integers(0, 1024, B).astype(np.int32)
    jo, jn, jok = (np.asarray(a) for a in jax.jit(js.spec_accept)(
        jnp.asarray(lg), jnp.asarray(drafts), jnp.asarray(n_drafts),
        jnp.asarray(temps), jnp.asarray(tks), jnp.asarray(tps),
        jnp.asarray(seeds), jnp.asarray(steps)))
    to, tn, tok = ts.spec_accept(
        torch.from_numpy(lg), torch.from_numpy(drafts.astype(np.int64)),
        torch.from_numpy(n_drafts.astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(tks.astype(np.int64)),
        torch.from_numpy(tps), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(steps.astype(np.int64)))
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tok.numpy(), jok)
    if K:
        assert (jn[:4] == K + 1).all() or temp > 0   # greedy: all land
        assert (jn[4:] < K + 1).any()


NGRAM_CASES = [([1, 2, 3, 1, 2, 3, 1, 2], 5, 3, 1),
               ([5, 5, 5, 5], 4, 3, 1), ([1, 2, 3, 4], 4, 3, 1),
               ([7], 4, 3, 1), ([], 4, 3, 1),
               ([9, 1, 2, 9, 1, 4, 9, 1], 1, 2, 1),
               ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9], 6, 3, 2),
               ([2, 2, 3, 2, 2], 0, 3, 1)]


@pytest.mark.parametrize("ctx,k,nmax,nmin", NGRAM_CASES)
def test_propose_ngram_matches_jax(ctx, k, nmax, nmin):
    want = js.propose_ngram(ctx, k, nmax, nmin)
    got = ts.propose_ngram(ctx, k, nmax, nmin)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sampling_params_validation():
    for bad in (dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
                dict(seed=-1)):
        with pytest.raises(ValueError):
            ts.SamplingParams(**bad)
    assert ts.GREEDY.greedy and not ts.SamplingParams(temperature=0.5).greedy
