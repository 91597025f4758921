"""The port's codec registry (dense-gf8, cauchy-xor, msr-pm) against
minio_tpu's, on the CPU: the codec matrices and repair plans, the
sub-shard view of the msr-pm codec through the port's engine, and
select_codec's picks. Every comparison is exact.

Each msr-pm geometry is built (and verified) once a process by each
package: 6+3 (coupled-layer, alpha 27) takes about a second here, so
the list of geometries stays short.
"""

import numpy as np
import pytest
import torch

from minio_tpu.erasure import registry as jax_registry
from minio_tpu.erasure.codec import Erasure as JaxErasure
from minio_tpu.ops import cauchy as jax_cauchy
from minio_tpu.ops import regen as jax_regen
from minio_tpu_torch.erasure import device_engine, registry
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.ops import cauchy, gf, regen
from minio_tpu_torch.utils.errors import ErrInvShardNum, ErrShardSize

torch.set_num_threads(1)

CODECS = (registry.DENSE_GF8, registry.CAUCHY_XOR, registry.MSR_PM)
GEOMETRIES = ((12, 4), (4, 4), (6, 3), (8, 2), (40, 40))


def _patterns(k: int, m: int) -> list[tuple[list, list]]:
    """(present, targets) cases: m data shards lost, the first and last
    parity lost, one middle shard lost."""
    n = k + m
    lost = [list(range(min(m, k))), [k, n - 1], [k // 2]]
    return [([i for i in range(n) if i not in t], t) for t in lost]


@pytest.mark.parametrize("k,m", GEOMETRIES)
@pytest.mark.parametrize("codec", CODECS)
def test_matrices_are_minio_tpus(codec, k, m):
    ours, theirs = registry.get(codec), jax_registry.get(codec)
    assert ours.wire_algorithm == theirs.wire_algorithm
    assert ours.geometry_ok(k, m) == theirs.geometry_ok(k, m)
    if not theirs.geometry_ok(k, m):
        return
    assert ours.alpha(k, m) == theirs.alpha(k, m)
    assert ours.declared_repair_fraction(k, m) == \
        theirs.declared_repair_fraction(k, m)
    np.testing.assert_array_equal(ours.coding_matrix(k, m),
                                  theirs.coding_matrix(k, m))
    np.testing.assert_array_equal(ours.parity_matrix(k, m),
                                  theirs.parity_matrix(k, m))
    for present, targets in _patterns(k, m):
        np.testing.assert_array_equal(
            ours.reconstruct_matrix(k, m, present, targets),
            theirs.reconstruct_matrix(k, m, present, targets))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_repair_plans_are_minio_tpus(k, m):
    assert regen.geometry_ok(k, m) == jax_regen.geometry_ok(k, m)
    assert regen.subshards(k, m) == jax_regen.subshards(k, m)
    assert regen.arm(k, m) == jax_regen.arm(k, m)
    assert regen.repair_read_fraction(k, m) == \
        jax_regen.repair_read_fraction(k, m)
    for target in range(k + m):
        ours = regen.repair_plan(k, m, target)
        theirs = jax_regen.repair_plan(k, m, target)
        assert (ours is None) == (theirs is None)
        if ours is None:
            continue
        assert (ours.target, ours.alpha, ours.beta, ours.reads) == \
            (theirs.target, theirs.alpha, theirs.beta, theirs.reads)
        np.testing.assert_array_equal(ours.matrix, theirs.matrix)


@pytest.mark.parametrize("k,m", [(1, 1), (4, 1), (1, 4), (200, 57)])
def test_refused_geometries_are_minio_tpus(k, m):
    assert regen.geometry_ok(k, m) == jax_regen.geometry_ok(k, m) is False


def test_cauchy_matrices_against_the_xor_schedule():
    """The port computes a Cauchy product with kernel A's plain version;
    minio_tpu's XOR schedule is the oracle."""
    k, m = 12, 4
    rng = np.random.default_rng(3)
    shards = rng.integers(0, 256, size=(2, k, 1031), dtype=np.uint8)
    codec = device_engine.for_geometry(k, m, registry.CAUCHY_XOR, "cpu")
    parity, _ = codec.encode_async(shards, with_hashes=False)
    want = jax_cauchy.apply_schedule_batch(cauchy.cauchy_parity_matrix(k, m),
                                           shards)
    np.testing.assert_array_equal(np.asarray(parity), want)
    np.testing.assert_array_equal(cauchy.cauchy_matrix(k, m),
                                  jax_cauchy.cauchy_matrix(k, m))


@pytest.mark.parametrize("k,m,size", [(12, 4, 12 * 4096 + 1), (4, 4, 3089),
                                      (6, 3, 1000), (8, 2, 5000)])
def test_subshard_view_encodes_and_rebuilds_as_minio_tpu(k, m, size):
    """msr-pm through the port's engine (alpha sub-shards a shard, the
    [.., K, S] -> [.., K*alpha, S/alpha] view around kernel A's plain
    version) against minio_tpu's Erasure and regen's host oracle."""
    data = np.random.default_rng(size).bytes(size)
    ours = Erasure(k, m, 1 << 20, registry.MSR_PM, device="cpu")
    theirs = JaxErasure(k, m, 1 << 20, jax_registry.MSR_PM)
    assert ours.subshards == theirs.subshards == regen.subshards(k, m)
    assert ours.shard_size() == theirs.shard_size()
    assert ours.shard_file_size(size) == theirs.shard_file_size(size)
    got = ours.encode_data(data)
    want = theirs.encode_data(data)
    assert len(got[0]) % ours.subshards == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.stack(got),
        regen.host_reference_encode(k, m, np.stack(got[:k])))
    lost = [0, k + m - 1][:m] if m > 1 else [0]
    shards = [None if i in lost else s for i, s in enumerate(got)]
    rebuilt = ours.reconstruct_targets(shards, lost)
    for t, r in zip(lost, rebuilt):
        np.testing.assert_array_equal(r, want[t])
    assert ours.join(ours.decode_data_blocks(shards), size) == data


def test_subshard_view_refuses_a_misfit_length():
    codec = device_engine.for_geometry(4, 4, registry.MSR_PM, "cpu")
    with pytest.raises(ErrShardSize):
        codec.encode_async(np.zeros((1, 4, 17), np.uint8), with_hashes=False)


def test_erasure_refuses_a_geometry_its_codec_cannot_build():
    with pytest.raises(ErrInvShardNum):
        Erasure(4, 1, 4096, registry.MSR_PM, device="cpu")


def test_registry_lookups_are_minio_tpus():
    assert registry.codec_ids() == jax_registry.codec_ids()
    for algo in ("rs-vandermonde", "rs-cauchy-xor", "rs-msr-pm", "nope"):
        assert registry.wire_algorithm_to_codec(algo) == \
            jax_registry.wire_algorithm_to_codec(algo)
    assert registry.AUTO_HYSTERESIS == jax_registry.AUTO_HYSTERESIS
    with pytest.raises(KeyError):
        registry.get("bogus")


# --- select_codec ------------------------------------------------------

@pytest.fixture
def selection(monkeypatch):
    """Both packages' auto-selection caches cleared before and after;
    minio_tpu's worker pool off."""
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.delenv("MTPU_CODEC", raising=False)
    monkeypatch.delenv("MTPU_CODEC_PROFILE", raising=False)
    for mod in (registry, jax_registry):
        mod._auto_codec.cache_clear()
    yield monkeypatch
    for mod in (registry, jax_registry):
        mod._auto_codec.cache_clear()


def _fixed_rates(mp, rates: dict) -> None:
    """Both packages' throughput probes replaced by fixed rates."""
    mp.setattr(registry, "probe_geometry_gbps",
               lambda cid, k, m, device: rates[cid])
    mp.setattr(jax_registry, "probe_geometry_gbps",
               lambda cid, k, m: rates[cid])


def _both(k, m, forced=""):
    return (registry.select_codec(k, m, forced=forced, device="cpu"),
            jax_registry.select_codec(k, m, forced=forced))


@pytest.mark.parametrize("env,forced,want", [
    ("", "cauchy-xor", "cauchy-xor"),
    ("cauchy-xor", "", "cauchy-xor"),
    ("cauchy-xor", "msr-pm", "msr-pm"),
    ("msr-pm", "auto", "dense-gf8"),
    ("auto", "", "dense-gf8"),
])
def test_selection_precedence(selection, env, forced, want):
    if env:
        selection.setenv("MTPU_CODEC", env)
    _fixed_rates(selection, {"dense-gf8": 1.0, "cauchy-xor": 1.1,
                             "msr-pm": 0.5})
    assert _both(12, 4, forced) == (want, want)


@pytest.mark.parametrize("k,m", [(12, 4), (4, 4), (6, 3), (8, 4)])
def test_heal_heavy_picks(selection, k, m):
    selection.setenv("MTPU_CODEC_PROFILE", "heal-heavy")
    _fixed_rates(selection, {"dense-gf8": 1.0, "cauchy-xor": 1.0,
                             "msr-pm": 1.0})
    ours, theirs = _both(k, m)
    assert ours == theirs
    if (k, m) in ((12, 4), (4, 4)):
        assert ours == registry.MSR_PM


@pytest.mark.parametrize("rates,want", [
    ({"dense-gf8": 1.0, "cauchy-xor": 1.2, "msr-pm": 0.4}, "dense-gf8"),
    ({"dense-gf8": 1.0, "cauchy-xor": 1.25, "msr-pm": 0.4}, "dense-gf8"),
    ({"dense-gf8": 1.0, "cauchy-xor": 1.3, "msr-pm": 0.4}, "cauchy-xor"),
    ({"dense-gf8": 1.0, "cauchy-xor": 1.3, "msr-pm": 1.6}, "msr-pm"),
])
def test_throughput_hysteresis(selection, rates, want):
    _fixed_rates(selection, rates)
    assert _both(12, 4) == (want, want)


def test_misfit_and_unknown_ids_raise_as_minio_tpus(selection):
    for fn in (lambda: registry.select_codec(4, 1, "msr-pm", device="cpu"),
               lambda: jax_registry.select_codec(4, 1, "msr-pm")):
        with pytest.raises(ValueError):
            fn()
    for fn in (lambda: registry.select_codec(4, 4, "bogus", device="cpu"),
               lambda: jax_registry.select_codec(4, 4, "bogus")):
        with pytest.raises(KeyError):
            fn()


def test_probe_runs_the_parity_apply(selection):
    """The real probe: a positive rate from the plain version on the CPU,
    once a process (cached)."""
    gbps = registry.probe_geometry_gbps(registry.MSR_PM, 4, 4,
                                        torch.device("cpu"))
    assert gbps > 0
    assert registry.probe_geometry_gbps(
        registry.MSR_PM, 4, 4, torch.device("cpu")) == gbps
    assert gf.bit_matrix_for(registry.get(registry.MSR_PM).parity_matrix(
        4, 4)).shape == (8 * 4 * 16, 8 * 4 * 16)
