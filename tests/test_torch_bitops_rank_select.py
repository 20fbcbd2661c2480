"""Port's bit ops, scans and binary rank/select vs the JAX reference.

Inputs come from a numpy seed and go to both packages as numpy arrays.
Every output is an exact integer, so every comparison is equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbitops
from repro.core import rank_select as jrs
from repro.core import scan as jscan
from repro_torch.core import bitops, rank_select as trs, scan

# jitted reference entry points: one compile per shape instead of one per
# primitive, which keeps this file fast
J_RANK = jax.jit(jrs.build_binary_rank, static_argnums=1)
J_BV = jax.jit(jrs.build_bitvector, static_argnums=(1, 2))
J_RANK1, J_RANK0, J_ACCESS = (jax.jit(jrs.rank1), jax.jit(jrs.rank0),
                              jax.jit(jrs.access_bit))
J_SELECT1, J_SELECT0 = jax.jit(jrs.select1), jax.jit(jrs.select0)


def _t(a) -> torch.Tensor:
    """numpy → torch, uint32/uint16 reinterpreted as int32/int16."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.array(a))


def _u(x) -> np.ndarray:
    """torch/jax → numpy with the port's int32/int16 leaves read back as
    the reference's unsigned patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.int32:
        return a.view(np.uint32).astype(np.int64)
    if a.dtype == np.int16:
        return a.view(np.uint16).astype(np.int64)
    return a.astype(np.int64)


def _bits(n: int, kind: str, seed: int = 0) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "ones":
        return np.ones(n, np.uint8)
    return np.random.default_rng(seed + n).integers(0, 2, n).astype(np.uint8)


def _words(bits: np.ndarray) -> np.ndarray:
    return np.asarray(jbitops.pack_bits(jbitops.pad_bits(jnp.asarray(bits))))


# (n, kind): odd n, all-zero and all-one rows, n at a word, a block and a
# superblock boundary, and one past them
CASES = [(1, "rand"), (32, "ones"), (33, "zeros"), (128, "rand"),
         (1024, "ones"), (1025, "rand"), (3001, "zeros")]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_pack_unpack_popcount(n):
    bits = _bits(n, "rand")
    want = _words(bits)
    got = bitops.pack_bits(bitops.pad_bits(torch.from_numpy(bits)))
    assert got.dtype == torch.int32
    assert np.array_equal(_u(got), want)
    assert bitops.num_words(n) == jbitops.num_words(n) == want.shape[0]
    assert np.array_equal(bitops.unpack_bits(got, n).numpy(),
                          np.asarray(jbitops.unpack_bits(jnp.asarray(want),
                                                         n)))
    assert np.array_equal(bitops.popcount(got).numpy(),
                          np.asarray(jbitops.popcount(jnp.asarray(want))))
    assert np.array_equal(
        bitops.word_prefix_popcount(got).numpy(),
        np.asarray(jbitops.word_prefix_popcount(jnp.asarray(want))))


def test_word_ops_match_reference():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    words[:3] = [0, 0xFFFFFFFF, 0x80000001]
    idx = rng.integers(0, 33, 500).astype(np.uint32)
    k = rng.integers(0, 33, 500).astype(np.int32)
    jw = jnp.asarray(words)
    assert np.array_equal(_u(bitops.to_i32(bitops.mask_below(_t(idx).long()))),
                          np.asarray(jbitops.mask_below(jnp.asarray(idx))))
    assert np.array_equal(
        bitops.rank1_word(_t(words), _t(idx)).numpy(),
        np.asarray(jbitops.rank1_word(jw, jnp.asarray(idx))))
    assert np.array_equal(
        bitops.select_in_word(_t(words), _t(k)).numpy(),
        np.asarray(jbitops.select_in_word(jw, jnp.asarray(k))))
    for lo_bit, width in ((0, 8), (5, 3), (24, 8), (31, 1)):
        assert np.array_equal(
            bitops.extract_field(_t(words), lo_bit, width).numpy(),
            np.asarray(jbitops.extract_field(jw, jnp.uint32(lo_bit), width)))


def test_scans_match_reference():
    rng = np.random.default_rng(2)
    flags = rng.integers(0, 2, 777).astype(np.int32)
    vals = rng.integers(0, 1000, 777).astype(np.int32)
    assert np.array_equal(scan.exclusive_sum(_t(vals)).numpy(),
                          np.asarray(jscan.exclusive_sum(jnp.asarray(vals))))
    dest = scan.stable_partition_indices(_t(flags))
    jdest = jscan.stable_partition_indices(jnp.asarray(flags))
    assert np.array_equal(dest.numpy(), np.asarray(jdest))
    assert np.array_equal(
        scan.apply_permutation_dest(_t(vals), dest).numpy(),
        np.asarray(jscan.apply_permutation_dest(jnp.asarray(vals), jdest)))
    # batched rows are independent
    two = torch.stack([_t(flags), _t(flags[::-1].copy())])
    assert np.array_equal(scan.stable_partition_indices(two)[1].numpy(),
                          np.asarray(jscan.stable_partition_indices(
                              jnp.asarray(flags[::-1].copy()))))


@pytest.mark.parametrize("n,kind", CASES)
def test_rank_matches_reference(n, kind):
    words = _words(_bits(n, kind))
    jr = J_RANK(jnp.asarray(words), n)
    tr = trs.build_binary_rank(_t(words), n)
    assert tr.superblock.dtype == torch.int32
    assert tr.block.dtype == torch.int16
    assert np.array_equal(_u(tr.superblock), _u(jr.superblock))
    assert np.array_equal(_u(tr.block), _u(jr.block))
    i = np.unique(np.concatenate([[0, n], np.random.default_rng(n).integers(
        0, n + 1, 64)])).astype(np.int32)
    ji = jnp.asarray(i)
    assert np.array_equal(trs.rank1(tr, _t(i)).numpy(),
                          np.asarray(J_RANK1(jr, ji)))
    assert np.array_equal(trs.rank0(tr, _t(i)).numpy(),
                          np.asarray(J_RANK0(jr, ji)))
    a = i[i < n]
    assert np.array_equal(trs.access_bit(tr, _t(a)).numpy(),
                          np.asarray(J_ACCESS(jr, jnp.asarray(a))))
    assert int(tr.total_ones) == int(jr.total_ones)


@pytest.mark.parametrize("n,kind", CASES)
@pytest.mark.parametrize("sample_rate", [64, 512])
def test_select_matches_reference(n, kind, sample_rate):
    bits = _bits(n, kind)
    words = _words(bits)
    jw = jnp.asarray(words)
    jbv = J_BV(jw, n, sample_rate)
    tbv = trs.build_bitvector(_t(words), n, sample_rate)
    assert np.array_equal(tbv.sel1.sample.numpy(),
                          np.asarray(jbv.sel1.sample))
    assert np.array_equal(tbv.sel0.sample.numpy(),
                          np.asarray(jbv.sel0.sample))
    ones, zeros = int(bits.sum()), n - int(bits.sum())
    for count, sel, jsel, fn, jfn in (
            (ones, tbv.sel1, jbv.sel1, trs.select1, J_SELECT1),
            (zeros, tbv.sel0, jbv.sel0, trs.select0, J_SELECT0)):
        if count == 0:
            continue
        # both ends and a spread in between
        k = np.unique(np.r_[0, count - 1,
                            np.linspace(0, count - 1, 20).astype(int)]
                      ).astype(np.int32)
        got = fn(tbv.rank, sel, _t(k)).numpy()
        assert np.array_equal(got, np.asarray(jfn(jbv.rank, jsel,
                                                  jnp.asarray(k))))
        target = 1 if sel is tbv.sel1 else 0
        assert np.array_equal(got, np.flatnonzero(bits == target)[k])


def test_bitvector_levels_batched_equals_per_level():
    rng = np.random.default_rng(3)
    n = 2049
    rows = np.stack([_words(rng.integers(0, 2, n).astype(np.uint8))
                     for _ in range(3)])
    rows[1] = _words(np.zeros(n, np.uint8))
    got = trs.build_bitvector_levels(_t(rows), n, 128)
    for l in range(3):
        want = J_BV(jnp.asarray(rows[l]), n, 128)
        assert np.array_equal(_u(got.rank.superblock[l]),
                              _u(want.rank.superblock))
        assert np.array_equal(_u(got.rank.block[l]), _u(want.rank.block))
        assert np.array_equal(got.sel1.sample[l].numpy(),
                              np.asarray(want.sel1.sample))
        assert np.array_equal(got.sel0.sample[l].numpy(),
                              np.asarray(want.sel0.sample))
    # the kernel route (the plain version on a CPU tensor) gives the same
    viak = trs.build_bitvector_levels(_t(rows), n, 128, use_kernels=True)
    assert torch.equal(viak.rank.superblock, got.rank.superblock)
    assert torch.equal(viak.rank.block, got.rank.block)


@pytest.mark.parametrize("n,kind", [(1, "rand"), (33, "ones"),
                                    (1000, "zeros"), (3001, "rand")])
def test_partition_select_matches_reference(n, kind):
    bits = _bits(n, kind)
    words = _words(bits)
    total_zeros = n - int(bits.sum())
    jd = jax.jit(jrs.partition_select_directory, static_argnums=1)(
        jnp.asarray(words), n)
    td = trs.partition_select_directory(_t(words), n)
    for got, want in zip(td, jd):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    g = trs.stable_partition_gather(_t(words), torch.tensor(total_zeros), n)
    jg = jax.jit(jrs.stable_partition_gather, static_argnums=2)(
        jnp.asarray(words), jnp.int32(total_zeros), n)
    assert np.array_equal(g.numpy(), np.asarray(jg))
    assert np.array_equal(g.numpy(), np.argsort(bits, kind="stable"))


@pytest.mark.parametrize("n", [1, 33, 1000])
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
def test_unpack_fields_round_trips_pack_fields(width, n):
    """The inputs of the reference's ``test_pack_fields_roundtrip``, on a
    fixed grid (it is a hypothesis test, which skips without hypothesis)."""
    vals = np.random.default_rng(n * 17 + width).integers(
        0, 1 << width, n).astype(np.uint32)
    words = bitops.pack_fields(_t(vals), width)
    assert words.shape == ((n * width + 31) // 32,)
    np.testing.assert_array_equal(
        _u(words), np.asarray(jbitops.pack_fields(jnp.asarray(vals), width)))
    back = bitops.unpack_fields(words, width, n)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbitops.unpack_fields(
            jbitops.pack_fields(jnp.asarray(vals), width), width, n)))


def test_extract_field_and_bit_match_reference():
    """The inputs of the reference's ``test_extract_field_and_bit``."""
    vals = np.asarray([0b101101, 0b011010], np.uint32)
    for bit in range(8):
        np.testing.assert_array_equal(
            bitops.extract_bit(_t(vals), bit).numpy(),
            np.asarray(jbitops.extract_bit(jnp.asarray(vals),
                                           jnp.uint32(bit))))
    np.testing.assert_array_equal(
        bitops.extract_bit(_t(vals), torch.tensor([0, 1])).numpy(), [1, 1])
    np.testing.assert_array_equal(bitops.extract_field(_t(vals), 2, 3).numpy(),
                                  [0b011, 0b110])


@pytest.mark.parametrize("dtype", ["uint32", "int32", "uint16",
                                   "float32"])
def test_pack_fields_out_dtype_matches_reference(dtype):
    vals = np.random.default_rng(5).integers(0, 16, 77).astype(np.uint32)
    want = np.asarray(jbitops.pack_fields(jnp.asarray(vals), 4,
                                          out_dtype_name=dtype))
    got = bitops.pack_fields(_t(vals), 4, out_dtype_name=dtype)
    if dtype == "uint32":
        assert got.dtype == torch.int32        # the uint32 pattern
        got = got.numpy().view(np.uint32)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_core_exposes_the_reference_surface():
    import repro.core
    import repro_torch.core
    missing = [n for n in repro.core.__all__
               if not hasattr(repro_torch.core, n)]
    assert not missing
    assert set(repro.core.__all__) <= set(repro_torch.core.__all__)
