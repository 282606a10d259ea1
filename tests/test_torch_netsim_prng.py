"""The port's counter-based PRNG (``repro_torch.netsim.prng``) against
``jax.random`` word for word: ``prng_key``, ``fold_in`` of the step indices,
link indices and salts the engine folds, ``random_bits`` and ``uniform`` at
the engine's draw shapes (``[F]``, ``[B, F]``, ``[B, L, F]`` from batched
keys), and ``scenario_key`` of the channel models. Every comparison is
bit-equal: the channel draws of the port and of the JAX package must be the
same numbers for the impaired runs to compare draw for draw."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import NetConfig as JNetConfig
from repro.config.base import stack_net_params as jstack
from repro.netsim.channel import scenario_key as jscenario_key
from repro_torch.config.net import NetConfig, stack_net_params
from repro_torch.netsim import prng
from repro_torch.netsim.channel import scenario_key

SEEDS = (0, 1, 7, 123, 2**31 - 1)
# the step indices of the issue's checks: the first steps, the golden
# congestion cell's src-PFC parting, the last step of a 220 ms run
STEPS = (0, 1, 306, 43_999)


def _key(k):
    return torch.as_tensor(np.asarray(k).astype(np.int64))


def _equal_words(jax_words, port):
    a = np.asarray(jax_words).astype(np.int64)
    b = port.numpy()
    assert a.shape == b.shape and np.array_equal(a, b), (a, b)


def _equal_f32(jax_vals, port):
    a = np.asarray(jax_vals, np.float32)
    b = port.numpy()
    assert a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    _equal_words(jax.random.PRNGKey(seed), prng.prng_key(seed))


@pytest.mark.parametrize("data", STEPS + (2, 3, 0xF1A9, 2**31 + 5))
@pytest.mark.parametrize("seed", (0, 123))
def test_fold_in_matches_jax(seed, data):
    key = jax.random.PRNGKey(seed)
    _equal_words(jax.random.fold_in(key, data), prng.fold_in(_key(key), data))


def test_fold_in_device_step_index_and_batched_keys():
    """The engine folds a 0-d int32 step tensor into ``[B, 2]`` keys, then
    the link indices into ``[B, 1, 2]`` keys: one call each, as JAX's vmap."""
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(3), s))(
        jnp.arange(5))
    for t in STEPS:
        want = jax.vmap(lambda k: jax.random.fold_in(k, jnp.int32(t)))(keys)
        got = prng.fold_in(_key(keys), torch.tensor(t, dtype=torch.int32))
        _equal_words(want, got)
    want = jax.vmap(lambda k: jax.vmap(lambda l: jax.random.fold_in(k, l))(
        jnp.arange(4)))(keys)
    _equal_words(want, prng.fold_in(_key(keys)[:, None, :], torch.arange(4)))


@pytest.mark.parametrize("shape", [(), (1,), (8,), (3, 5), (1000,)])
def test_bits_and_uniform_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 306)
    _equal_words(jax.random.bits(key, shape), prng.random_bits(_key(key), shape))
    _equal_f32(jax.random.uniform(key, shape, jnp.float32),
               prng.uniform(_key(key), shape))


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_uniform_from_batched_keys_matches_vmap(lead):
    """``[B, F]`` and ``[B, L, F]`` draws from ``[B, 2]`` / ``[B, L, 2]``
    keys: each key draws as it would alone (JAX under vmap)."""
    n = int(np.prod(lead))
    flat = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5), s))(
        jnp.arange(n))
    want = jax.vmap(lambda k: jax.random.uniform(k, (8,)))(flat)
    got = prng.uniform(_key(flat).reshape(*lead, 2), (8,))
    _equal_f32(np.asarray(want).reshape(*lead, 8), got)


def test_loss_and_jitter_subkeys_in_one_call():
    """The impaired channel derives its loss and jitter subkeys (0 and 1) in
    one ``fold_in`` and draws both in one ``uniform``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 43_999)
    want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, s),
                                                   (8,))) for s in (0, 1)])
    got = prng.uniform(prng.fold_in(_key(key)[None, :], torch.tensor([0, 1])), (8,))
    _equal_f32(want, got)


def test_f32_bits_are_jax_bitcast():
    x = np.array([0.0, -0.0, 0.01, 4.0, 25.0, 1e30, 500.0], np.float32)
    want = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.uint32)
    _equal_words(want, prng.f32_bits(torch.as_tensor(x)))


KNOBS = [dict(loss_rate=0.01, loss_burst_len=4.0, jitter_us=25.0),
         dict(loss_rate=0.01, loss_burst_len=25.0, jitter_us=4.0),
         dict(flap_period_us=2000.0, flap_depth=0.5, distance_km=50.0),
         dict(flap_period_us=0.5, flap_depth=2000.0, distance_km=50.0),
         dict(distance_km=300.0), dict()]


@pytest.mark.parametrize("seed", (0, 123))
def test_scenario_key_matches_jax(seed):
    """Knob values permuted across fields (rows 0/1 and 2/3) land on
    different keys, in both packages, bit for bit."""
    jk = jax.vmap(lambda p: jscenario_key(jax.random.PRNGKey(seed), p))(
        jstack([JNetConfig(**k) for k in KNOBS]))
    pk = scenario_key(prng.prng_key(seed),
                      stack_net_params([NetConfig(**k) for k in KNOBS], device="cpu"))
    _equal_words(jk, pk)
    rows = {tuple(r) for r in pk.numpy().tolist()}
    assert len(rows) == len(KNOBS)
