"""The arithmetic of the 3xTF32 float32 bodies (csrc/ln_gemm_f32.cu,
csrc/self_attention_f32.cu, csrc/flash_attention_f32.cu,
csrc/flash_attention_bwd_f32.cu), emulated in numpy on the CPU.

Each float32 operand x runs on Hopper's tensor cores as two TF32 parts,
hi = tf32(x) and lo = tf32(x - hi) (`cvt.rna.tf32.f32`: round to nearest,
ties away from zero, low 13 bits zero), and a product a b as
a_lo b_hi + a_hi b_lo + a_hi b_hi. The tensor cores add each 8-deep
product into their float32 accumulator with truncation; the kernels
therefore sum one K step's products in a fresh partial (32 deep in
ln_gemm_f32, one 64-key chunk in the attention bodies' P V) and add the
partials in float32 with ordinary rounding. Here: the split itself, that
schedule against float64 at the main path's K (768, 3072), in the
attention chain (scores, exact softmax, split P, P V), within the card's
bound of 1e-5 rel-L2 with margin, the softmax's division, and the index
maps the kernels use to feed P to P V and to transpose V
(csrc/f32_chunk.cuh; no card needed). The backward kernels and
flash_attention_f32 split with `tf32_split_fast` (lo left for the tensor
cores to read, emulated as its truncation): their schedules (the forward's
online softmax over 64-key chunks by ex2 at 400 to 4096 keys and its
log-sum-exp; the self-attention's row statistics made from the keys, both
backward kernels' products, each into a fresh tile) against float64 at
the layer's and the 512 px and 1024 px token counts, the row quads' key
map, and the kernels' turns on the tensor cores over their rings, run as
state machines."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

# the bound each float32 body is held to against its plain version on the card
F32_KERNEL_REL_L2 = 1e-5
# what the emulated schedule must reach: a quarter of the card's bound
MARGIN = 0.25


def tf32_rna(x):
    """`cvt.rna.tf32.f32` on float32 bits: add half of the 13 dropped bits'
    weight to the magnitude (sign-magnitude bits: ties away from zero),
    then clear them."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_parts(x):
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_trunc(x):
    """A TF32 operand as the tensor cores read a 32-bit value: its low 13
    bits ignored (round toward zero)."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_parts_as_stored(x):
    """The parts flash_attention_f32's splitters store for K and V: x as it
    is, read by the tensor cores as its truncation, and lo = x -
    trunc(x) (exact), read truncated too."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(np.asarray(x, dtype=np.float32) - hi)


def tf32_parts_fast(x):
    """`tf32_split_fast`'s parts as the tensor cores read them: hi =
    tf32(x) (the integer add and mask: `tf32_rna`'s formula), lo = x - hi
    (exact) kept as it is, read as its truncation (the least accurate
    reading; a rounding one would give `tf32_parts`)."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def _rz32(x64):
    """float64 -> float32 rounded toward zero (the tensor cores' adds)."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_product(a, b, flush=None, split=tf32_parts, split_b=None):
    """a (M, K) @ b (K, N), float32 operands, as the kernels issue it: per
    8-deep step lo b_hi, hi b_lo, hi b_hi, each an exact 8-term sum added
    into a float32 partial with truncation; every `flush` columns of K the
    partial is added into a float32 sum with rounding (None: one chain).
    `split`: the operands' parts (round to nearest, or tf32_parts_fast);
    `split_b`, if given, b's."""
    ah, al = split(a)
    bh, bl = (split_b or split)(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(total)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _rz32(part.astype(np.float64)
                         + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
        if flush and (k0 + 8) % flush == 0:
            total, part = total + part, np.zeros_like(part)
    return total + part


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref) / np.linalg.norm(ref))


def _layer_norm(x, scale, shift):
    """The plain version's float32 LayerNorm (eps 1e-5)."""
    mean = x.mean(-1, keepdims=True, dtype=np.float32)
    var = np.square(x - mean).mean(-1, keepdims=True, dtype=np.float32)
    return ((x - mean) * (np.float32(1) / np.sqrt(var + np.float32(1e-5)))) * scale + shift


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    cases = {  # x: tf32(x)
        one: one,
        one + ulp / 2: one + ulp,            # a tie: away from zero
        -(one + ulp / 2): -(one + ulp),
        one + ulp / 2 - np.float32(2.0 ** -23): one,
        one + ulp * 1.5: one + 2 * ulp,       # a tie above an odd mantissa: still away
        np.float32(2.0) - np.float32(2.0 ** -23): np.float32(2.0),  # the carry into the exponent
        np.float32(0.0): np.float32(0.0),
    }
    got = tf32_rna(np.array(list(cases), np.float32))
    np.testing.assert_array_equal(got, np.array(list(cases.values()), np.float32))


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
def test_tf32_parts_reconstruct_within_2_pow_minus_22(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 16) * scale).astype(np.float32)
    hi, lo = tf32_parts(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    # x - hi is exact in float32, so lo is the TF32 of the true remainder
    np.testing.assert_array_equal((x - hi).astype(np.float64),
                                  x.astype(np.float64) - hi.astype(np.float64))
    err = np.abs(x.astype(np.float64) - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
def test_tf32_fast_parts_reconstruct_within_2_pow_minus_21(scale):
    """The backward kernels' split as the tensor cores read it at worst (lo
    truncated): both parts TF32 (low 13 bits zero), hi round to nearest,
    lo = x - hi exact before it is read, hi + lo within 2^-21 of x."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 16) * scale).astype(np.float32)
    hi, lo = tf32_parts_fast(x)
    np.testing.assert_array_equal(hi, tf32_parts(x)[0])
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    np.testing.assert_array_equal((x - hi).astype(np.float64),
                                  x.astype(np.float64) - hi.astype(np.float64))
    err = np.abs(x.astype(np.float64) - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert np.all(err <= 2.0 ** -21 * np.abs(x.astype(np.float64)))


# the main path's products: (name, K, N, LayerNorm prologue)
GEMMS = [("qkv (LN1)", 768, 128, True), ("expand", 768, 128, False),
         ("contract", 3072, 128, False), ("ln K=1024", 1024, 64, True),
         ("K=200", 200, 64, False)]


@pytest.mark.parametrize("name,k,n,ln", GEMMS, ids=[g[0] for g in GEMMS])
def test_ln_gemm_schedule_is_float32_accurate(name, k, n, ln):
    """ln_gemm_f32's schedule (3xTF32, a fresh partial per 32-deep K step)
    against float64, beside a plain float32 product of the same operands."""
    rng = np.random.default_rng(k + n)
    a = rng.standard_normal((64, k)).astype(np.float32)
    if ln:
        a = _layer_norm(a, (1 + 0.1 * rng.standard_normal(k)).astype(np.float32),
                        (0.1 * rng.standard_normal(k)).astype(np.float32)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ w.T.astype(np.float64)
    got = _rel(tc_product(a, w.T, flush=32), ref)
    plain = _rel(a @ w.T, ref)
    assert got <= MARGIN * F32_KERNEL_REL_L2, (name, got, plain)
    assert got <= 4 * plain + 1e-7, (name, got, plain)


def test_one_truncating_chain_drifts_past_the_bound():
    """Why the kernels flush: one truncating chain over the contract's K =
    3072 (1152 adds) misses 1e-5; a fresh partial per 32 keeps ~3e-7."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 3072)).astype(np.float32)
    w = (rng.standard_normal((3072, 64)) * 3072 ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    assert _rel(tc_product(a, w), ref) > F32_KERNEL_REL_L2
    assert _rel(tc_product(a, w, flush=32), ref) < MARGIN * F32_KERNEL_REL_L2


def _attention_ref(q, k, v, n):
    s = (q.astype(np.float64) @ k.T.astype(np.float64))[:, :n] / 8.0
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v[:n].astype(np.float64)


@pytest.mark.parametrize("n", [256, 200, 64, 1])
def test_attention_chain_is_float32_accurate(n):
    """self_attention_f32's chain for one 64-query tile: S = Q K^T in 3xTF32
    (one chain per 64-key chunk), the exact float32 softmax (s / 8, keys past
    N at -inf, max, exp, sum, divide), P split, P V in 3xTF32 with a fresh
    partial per 64-key chunk; against float64."""
    rng = np.random.default_rng(n)
    keys = -(-n // 64) * 64  # the chunks' keys; past N zeros, as TMA fills them
    q = rng.standard_normal((64, 64)).astype(np.float32)
    k = np.zeros((keys, 64), np.float32)
    v = np.zeros((keys, 64), np.float32)
    k[:n] = rng.standard_normal((n, 64))
    v[:n] = rng.standard_normal((n, 64))
    s = np.concatenate([tc_product(q, k[c:c + 64].T) for c in range(0, keys, 64)], axis=1)
    s = s * np.float32(0.125)
    s[:, n:] = -np.inf
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True, dtype=np.float32)
    o = tc_product(p.astype(np.float32), v, flush=64)
    ref = _attention_ref(q, k, v, n)
    # the plain float32 chain, for the message
    sp = (q @ k.T) * np.float32(0.125)
    sp[:, n:] = -np.inf
    ep = np.exp(sp - sp.max(-1, keepdims=True))
    plain = _rel((ep / ep.sum(-1, keepdims=True, dtype=np.float32)) @ v, ref)
    assert _rel(o, ref) <= MARGIN * F32_KERNEL_REL_L2, (_rel(o, ref), plain)


SCALE_LOG2E = np.float32(0.18033688011112042)  # log2(e) / 8, as the kernel rounds it
LN2 = np.float32(0.69314718055994531)


def _ex2(x):
    """`ex2.approx.ftz.f32` as the emulation takes it: 2^x rounded to
    float32, then moved by its relative error bound, 2^-22, up or down with
    the parity of x's bits (a fixed sign that varies with the data)."""
    x = np.ascontiguousarray(x, np.float32)
    sign = np.where(x.view(np.uint32) & 1, 1.0, -1.0)
    return (np.exp2(x.astype(np.float64)) * (1 + sign * 2.0 ** -22)).astype(np.float32)


def _flash_schedule(q, k, v, n):
    """flash_attention_f32.cu's schedule for the query rows q against n keys
    (k, v zero past n up to whole 64-key chunks, as TMA fills them), Q's
    and P's TF32 parts `tf32_split_fast`'s, K's and V's as the splitters
    store them (`tf32_parts_as_stored`): per chunk S = Q K^T in 3xTF32 (one
    chain), keys past n at -inf; the row's offset nm = -(m C) (C = log2(e)
    / 8, m the running max; +inf before the first chunk) as min(nm_old,
    -(chunk max C)) in float32, c = ex2(nm - nm_old) where nm moved (else
    1: a drift of ex2's error at 0 over the chunks would add up), e = ex2(s
    C + nm) by one FFMA; each thread's sum of its 16 keys of a row (keys 8 j + 2 t4 and
    + 1) carried as l = l c + sum by FMA; P V in 3xTF32 on P's fast parts
    into a fresh partial (one chain per chunk) and O = O c + partial by
    FMA; at the end the quad's four sums added as the shuffles add them,
    O / l, and lse = log(l) - nm log(2) by FMA. Returns (o, lse)."""
    rows = q.shape[0]
    nm = np.full(rows, np.inf, np.float32)
    l = np.zeros((rows, 4), np.float32)
    o = np.zeros((rows, 64), np.float32)
    for c0 in range(0, k.shape[0], 64):
        s = tc_product(q, k[c0:c0 + 64].T, split=tf32_parts_fast, split_b=tf32_parts_as_stored)
        s[:, np.arange(c0, c0 + 64) >= n] = -np.inf
        new = np.minimum(nm, -(s.max(-1) * SCALE_LOG2E))
        cf = np.where(new == nm, np.float32(1), _ex2(new - nm))
        e = _ex2(_fma(s, SCALE_LOG2E, new[:, None]))
        pairs = e.reshape(rows, 8, 4, 2).sum(-1, dtype=np.float32)  # (rows, j, t4)
        sums = np.zeros((rows, 4), np.float32)
        for j in range(8):
            sums = sums + pairs[:, j]
        l = _fma(l, cf[:, None], sums)
        o = _fma(o, cf[:, None], tc_product(e, v[c0:c0 + 64], split=tf32_parts_fast,
                                            split_b=tf32_parts_as_stored))
        nm = new
    total = (l[:, 0] + l[:, 1]) + (l[:, 2] + l[:, 3])
    return o / total[:, None], _fma(nm, -LN2, np.log(total))


def _check_flash_schedule(rows, n):
    """The schedule for `rows` query rows against n keys: o within a quarter
    of the card's bound of float64, lse within the card test's 1e-6."""
    rng = np.random.default_rng(n)
    keys = -(-n // 64) * 64
    q = rng.standard_normal((rows, 64)).astype(np.float32)
    k = np.zeros((keys, 64), np.float32)
    v = np.zeros((keys, 64), np.float32)
    k[:n] = rng.standard_normal((n, 64))
    v[:n] = rng.standard_normal((n, 64))
    o, lse = _flash_schedule(q, k, v, n)
    got = _rel(o, _attention_ref(q, k, v, n))
    assert got <= MARGIN * F32_KERNEL_REL_L2, got
    s64 = q.astype(np.float64) @ k[:n].T.astype(np.float64) / 8.0
    ref_lse = s64.max(-1) + np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1))
    assert _rel(lse, ref_lse) <= 1e-6, _rel(lse, ref_lse)


@pytest.mark.parametrize("n", [1024, 4096, 400])
def test_flash_schedule_is_float32_accurate(n):
    """flash_attention_f32's streaming chain for 8 query rows at the 512 px
    and 1024 px token counts and a ragged grid's, against float64."""
    _check_flash_schedule(8, n)


def test_flash_schedule_cross_shaped_is_float32_accurate():
    """The same for a cross-shaped call (Nq != Nk): 200 query rows against
    521 keys, a ragged last chunk of 9."""
    _check_flash_schedule(200, 521)


def _slot(key):
    """The V^T slot of key `key` of a chunk (f32_chunk.cuh's splitter)."""
    return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)


def test_score_accumulators_feed_p_v_in_slot_order():
    """A thread's score accumulators of an 8-key block (keys 2 t4 and
    2 t4 + 1 of rows g and g + 8, s[4 j + e]) are the TF32 A fragment of
    the slots t4 and t4 + 4 (a[0], a[2] of row g; a[1], a[3] of row g + 8)
    when V^T holds key k at _slot(k); the slots are a permutation."""
    assert sorted(_slot(k) for k in range(64)) == list(range(64))
    for j in range(8):
        for t4 in range(4):
            # the kernel's fragment: x = (s[4j], s[4j+2], s[4j+1], s[4j+3])
            frag_keys = {0: 8 * j + 2 * t4, 1: 8 * j + 2 * t4, 2: 8 * j + 2 * t4 + 1,
                         3: 8 * j + 2 * t4 + 1}
            frag_slots = {0: 8 * j + t4, 1: 8 * j + t4, 2: 8 * j + t4 + 4, 3: 8 * j + t4 + 4}
            for i in range(4):
                assert _slot(frag_keys[i]) == frag_slots[i]


def _sw_off(row, col):
    """f32_chunk.cuh's sw_off: element (row, col) of a 64 x 64 float32
    chunk held as two 128-byte-swizzled 64 x 32 boxes."""
    return (col >> 5) * 8192 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4


def _v_unit(u):
    """f32_chunk.cuh's V^T split unit u (0..511): (kg, h, dq, e),
    keys 8 kg + 2 i + h (i = 0..3) x head columns 4 dq + 2 e and + 1."""
    lane, w = u & 31, u >> 5
    return w >> 1, (lane >> 3) & 1, (lane & 7) | ((w & 1) << 3), (lane >> 4) & 1


def test_v_transpose_is_conflict_free_and_complete():
    """The splitters' V^T pass: a unit reads 4 keys x 2 head columns (four
    8-byte reads) and writes each column's 4 keys as 16 contiguous bytes of
    V^T (slots 8 kg + 4 h ..). A warp's reads hit each bank twice for 256
    bytes and its writes each 16-byte bank group 4 times for 512 (the least
    numbers of shared-memory wavefronts); every (dim, slot) is written once,
    with the key _slot maps to it."""
    written = set()
    for w0 in range(0, 512, 32):
        units = [_v_unit(u) for u in range(w0, w0 + 32)]
        for i in range(4):
            banks = [b for kg, h, dq, e in units
                     for b in ((_sw_off(8 * kg + 2 * i + h, 4 * dq + 2 * e) // 4 + d) % 32
                               for d in (0, 1))]
            assert sorted(banks.count(b) for b in range(32)) == [2] * 32
        for j in range(2):
            offs = [_sw_off(4 * dq + 2 * e + j, 8 * kg + 4 * h) for kg, h, dq, e in units]
            assert sorted([(off // 16) % 8 for off in offs].count(b) for b in range(8)) == [4] * 8
            for kg, h, dq, e in units:
                for i in range(4):
                    assert _slot(8 * kg + 2 * i + h) == 8 * kg + 4 * h + i
                    written.add((4 * dq + 2 * e + j, 8 * kg + 4 * h + i))
    assert written == {(d, s) for d in range(64) for s in range(64)}


def _vt_block(u):
    """flash_attention_f32.cu's V^T split unit u (0..255): (kg, h, dq),
    keys 8 kg + 2 i + h (i = 0..3) x head columns 4 dq .. 4 dq + 3."""
    l3 = u & 7
    dq = l3 | ((u >> 3) & 8)
    kb = (((l3 >> 1) ^ (u >> 3)) & 7) | ((u >> 4) & 8)
    return kb >> 1, kb & 1, dq


def test_flash_v_transpose_blocks_are_conflict_free_and_complete():
    """flash_attention_f32's V^T pass in 4 x 4 blocks: a unit reads 4 keys x
    4 head columns (four 16-byte reads) and writes each column's 4 keys as
    16 contiguous bytes of V^T (slots 8 kg + 4 h ..). Each quarter warp (8
    consecutive units of a splitter warp, whose units start at multiples of
    32) reads and writes 8 distinct 16-byte bank groups (one wavefront an
    instruction, the least); every (dim, slot) is written once, with the key
    _slot maps to it; the 16 bytes read are 4 columns of one row."""
    written = set()
    for q0 in range(0, 256, 8):
        units = [_vt_block(u) for u in range(q0, q0 + 8)]
        for i in range(4):
            offs = [_sw_off(8 * kg + 2 * i + h, 4 * dq) for kg, h, dq in units]
            assert all(_sw_off(8 * kg + 2 * i + h, 4 * dq + 3) == off + 12
                       for (kg, h, dq), off in zip(units, offs))
            assert sorted((off // 16) % 8 for off in offs) == list(range(8))
        for j in range(4):
            offs = [_sw_off(4 * dq + j, 8 * kg + 4 * h) for kg, h, dq in units]
            assert sorted((off // 16) % 8 for off in offs) == list(range(8))
            for kg, h, dq in units:
                for i in range(4):
                    assert _slot(8 * kg + 2 * i + h) == 8 * kg + 4 * h + i
                    assert _sw_off(4 * dq + j, 8 * kg + 4 * h + i) == (
                        _sw_off(4 * dq + j, 8 * kg + 4 * h) + 4 * i)
                    written.add((4 * dq + j, 8 * kg + 4 * h + i))
    assert written == {(d, s) for d in range(64) for s in range(64)}


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even), exactly (normal range)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    m = scaled.numerator // scaled.denominator
    rest = scaled - m
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and m % 2):
        m += 1
    return sign * m * Fraction(2) ** (e - 23)


def test_softmax_division_by_reciprocal_and_one_fma_is_exact():
    """self_attention_f32 divides each e by the row sum as q = e * (1 / sum)
    and q + (e - q sum) / sum's FMA correction (Markstein): the float32
    quotient rounded to nearest, as e / sum gives it."""
    rng = np.random.default_rng(5)
    e = np.exp(-rng.uniform(0, 20, 3000)).astype(np.float32)
    sums = (1 + rng.uniform(0, 255, 3000)).astype(np.float32)
    for ei, si in zip(e.tolist(), sums.tolist()):
        ef, sf = Fraction(ei), Fraction(si)
        inv = _rn32(1 / sf)
        q = _rn32(ef * inv)
        got = _rn32(_rn32(ef - q * sf) * inv + q)  # fmaf(fmaf(-q, sum, e), inv, q)
        assert got == _rn32(ef / sf), (ei, si)


# ---- the float32 attention backwards (csrc/flash_attention_bwd_f32.cu) ----


def _tc(a, b):
    """A product of the backward kernels: 3xTF32 in one chain of 8-deep
    steps into a fresh tile, the parts made by `tf32_split_fast`."""
    return tc_product(a, b, split=tf32_parts_fast)


def _fma(a, b, c):
    """a b + c rounded once to float32 (float32 operands: a b is exact in
    float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _thread_keys(t4):
    """The keys of a 64-key chunk that thread t4 of a row's quad holds, in
    its loop's order (j outer, e inner): 8 j + 2 t4 + e."""
    return [8 * j + 2 * t4 + e for j in range(8) for e in range(2)]


def _row_stats(q, k, g, v, n):
    """The dq kernel's first pass (self-attention mode) for the query rows
    q: per 64-key chunk S = Q K^T and dP = g V^T in 3xTF32 (a fresh tile
    each), each thread's running max m of its keys' s (keys past n left
    out), l = l c + sum exp(s / 8 - m / 8) and t = t c + sum exp(..) dp by
    FMA; then the quad's four merged (max, rescale, the shuffles' sums)
    into lse = m / 8 + log l and D = t / l, float32."""
    rows, sc = q.shape[0], np.float32(0.125)
    m = np.full((rows, 4), -np.inf, np.float32)
    l = np.zeros((rows, 4), np.float32)
    t = np.zeros((rows, 4), np.float32)
    for c0 in range(0, k.shape[0], 64):
        s, dp = _tc(q, k[c0:c0 + 64].T), _tc(g, v[c0:c0 + 64].T)
        for t4 in range(4):
            keys = [c for c in _thread_keys(t4) if c0 + c < n]
            if not keys:
                continue
            mx = np.maximum(m[:, t4], s[:, keys].max(1))
            nm = -mx * sc
            cf = np.exp(_fma(m[:, t4], sc, nm))
            ls = np.zeros(rows, np.float32)
            ts = np.zeros(rows, np.float32)
            for c in keys:
                ex = np.exp(_fma(s[:, c], sc, nm))
                ls = ls + ex
                ts = _fma(ex, dp[:, c], ts)
            l[:, t4], t[:, t4], m[:, t4] = _fma(l[:, t4], cf, ls), _fma(t[:, t4], cf, ts), mx
    mq = m.max(1)
    with np.errstate(invalid="ignore"):
        cf = np.exp(_fma(m, sc, (-mq * sc)[:, None]))
    lq, tq = l * cf, t * cf
    lq = (lq[:, 0] + lq[:, 1]) + (lq[:, 2] + lq[:, 3])
    tq = (tq[:, 0] + tq[:, 1]) + (tq[:, 2] + tq[:, 3])
    return _fma(mq, sc, np.log(lq)), tq / lq


def _bwd_schedule(q, k, v, g, n, lse, delta, q_rows, k_rows):
    """The two kernels' schedule: dq of the query rows q_rows (per key
    chunk S and dP in 3xTF32, p = exp(s / 8 - lse), ds = p (dp - D) / 8,
    keys past n at 0, dq += a fresh 3xTF32 partial of ds K), dk and dv of
    the key rows k_rows (per query chunk S^T, dP^T, p^T, ds^T from the
    chunk's lse and D, rows past n at lse = +inf and D = 0; dk += ds^T Q,
    dv += p^T g, each a fresh partial), all float32."""
    sc = np.float32(0.125)
    dq = np.zeros((len(q_rows), 64), np.float32)
    for c0 in range(0, k.shape[0], 64):
        s = _tc(q[q_rows], k[c0:c0 + 64].T)
        dp = _tc(g[q_rows], v[c0:c0 + 64].T)
        p = np.exp(_fma(s, sc, -lse[q_rows][:, None]))
        ds = (p * (dp - delta[q_rows][:, None])) * sc
        ds[:, np.arange(c0, c0 + 64) >= n] = 0
        dq = dq + _tc(ds, k[c0:c0 + 64])
    dk = np.zeros((len(k_rows), 64), np.float32)
    dv = np.zeros((len(k_rows), 64), np.float32)
    for c0 in range(0, q.shape[0], 64):
        st = _tc(k[k_rows], q[c0:c0 + 64].T)
        dpt = _tc(v[k_rows], g[c0:c0 + 64].T)
        with np.errstate(invalid="ignore"):
            pt = np.exp(_fma(st, sc, -lse[c0:c0 + 64][None]))
        dst = (pt * (dpt - delta[c0:c0 + 64][None])) * sc
        dk = dk + _tc(dst, q[c0:c0 + 64])
        dv = dv + _tc(pt, g[c0:c0 + 64])
    return dq, dk, dv


def _bwd_ref(q, k, v, g, n):
    """float64 dq, dk, dv of softmax(q k^T / 8) v over the first n rows."""
    q, k, v, g = (x[:n].astype(np.float64) for x in (q, k, v, g))
    s = q @ k.T / 8.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    dp = g @ v.T
    ds = p * (dp - (p * dp).sum(-1, keepdims=True)) / 8.0
    return ds @ k, ds.T @ q, p.T @ g, p, dp


def _padded_qkvg(rng, n, std_g):
    """q, k, v, g of n rows, zero to whole 64-row chunks (as TMA fills the
    chunks past n)."""
    rows = -(-n // 64) * 64
    out = []
    for std in (1.0, 1.0, 1.0, std_g):
        x = np.zeros((rows, 64), np.float32)
        x[:n] = rng.standard_normal((n, 64)) * std
        out.append(x)
    return out


@pytest.mark.parametrize("n", [256, 200, 144, 64, 37])
def test_self_attention_bwd_schedule_is_float32_accurate(n):
    """self_attention_bwd_f32 on the flash kernels: the dq kernel's row
    statistics made from the keys (lse and D = sum p dp, rows past n
    padded as lse = +inf, D = 0), then both kernels' products, for one head
    at the layer's token counts (whole, and ragged at 200, 144 and 37), against
    float64; lse and D against float64 too."""
    rng = np.random.default_rng(n + 7)
    q, k, v, g = _padded_qkvg(rng, n, 0.1)
    lse, delta = _row_stats(q, k, g, v, n)
    rows = q.shape[0]
    lse[n:], delta[n:] = np.inf, 0
    dq, dk, dv = _bwd_schedule(q, k, v, g, n, lse, delta, np.arange(n), np.arange(n))
    rdq, rdk, rdv, p, dp = _bwd_ref(q, k, v, g, n)
    s64 = q[:n].astype(np.float64) @ k[:n].T.astype(np.float64) / 8.0
    ref_lse = s64.max(-1) + np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1))
    assert rows % 64 == 0
    assert _rel(lse[:n], ref_lse) <= MARGIN * F32_KERNEL_REL_L2
    assert _rel(delta[:n], (p * dp).sum(-1)) <= MARGIN * F32_KERNEL_REL_L2
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert _rel(got, ref) <= MARGIN * F32_KERNEL_REL_L2, (name, _rel(got, ref))


@pytest.mark.parametrize("n", [1024, 576])
def test_flash_bwd_schedule_is_float32_accurate(n):
    """flash_attention_bwd_f32's two kernels at the 512 px token count (and
    a last 128-row block of 64 rows): D = rowsum(g o) by each row's two
    threads (32 columns each, FMA, then added), lse the forward's, and the
    products of 8 query rows' dq and 8 key rows' dk, dv against float64."""
    rng = np.random.default_rng(n)
    q, k, v, g = _padded_qkvg(rng, n, 0.1)
    rdq, rdk, rdv, p, dp = _bwd_ref(q, k, v, g, n)
    o = (p @ v[:n].astype(np.float64)).astype(np.float32)
    halves = []
    for h in range(2):
        acc = np.zeros(n, np.float32)
        for c in range(32 * h, 32 * h + 32):
            acc = _fma(g[:n, c], o[:, c], acc)
        halves.append(acc)
    delta = halves[0] + halves[1]
    s64 = q[:n].astype(np.float64) @ k[:n].T.astype(np.float64) / 8.0
    lse = (s64.max(-1) + np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1))).astype(
        np.float32)
    rows = np.array([0, 1, 63, 64, 300, 511, n - 2, n - 1])
    dq, dk, dv = _bwd_schedule(q, k, v, g, n, lse, delta, rows, rows)
    for name, got, ref in (("dq", dq, rdq[rows]), ("dk", dk, rdk[rows]), ("dv", dv, rdv[rows])):
        assert _rel(got, ref) <= MARGIN * F32_KERNEL_REL_L2, (name, _rel(got, ref))


def test_row_quads_hold_every_key_once():
    """The row statistics' index map: the four threads of a row's quad hold
    the keys 8 j + 2 t4 + e of each chunk, every key once (so the merged
    max and sums see the whole row), and their accumulators s[4 j + 2 h +
    e] of rows r (h = 0) and r + 8 (h = 1) are the m64n64 accumulator
    layout's (row 8 (i / 2) + .., column 8 j + 2 t4 + i % 2 for s[4 j + i])."""
    assert sorted(c for t4 in range(4) for c in _thread_keys(t4)) == list(range(64))
    for t4 in range(4):
        for j in range(8):
            for h in range(2):
                for e in range(2):
                    i = 2 * h + e  # the accumulator s[4 j + i]
                    assert (i // 2, 8 * j + 2 * t4 + i % 2) == (h, _thread_keys(t4)[2 * j + e])


def _ring_schedule(mode, n_chunks, items):
    """The split ring's positions in the kernel's order and each consumer
    run's positions: per chunk dq takes K, V (S and dP), then K^T (dS K);
    its self-attention mode first a pass of K, V per chunk; dk/dv takes Q,
    g (S^T and dP^T), then Q^T, g^T (dk and dv). Returns the runs of one
    warpgroup: (item, positions, reads the item)."""
    runs, p = [], 0
    for it in range(items):
        passes = 2 if mode == "dq_stats" else 1
        for pas in range(passes):
            for c in range(n_chunks):
                last_t0 = pas == passes - 1 and c == n_chunks - 1
                runs.append((it, [p, p + 1], True, last_t0))
                p += 2
                if mode == "dq_stats" and pas == 0:
                    continue
                width = 2 if mode == "dkv" else 1
                runs.append((it, list(range(p, p + width)), False, False))
                p += width
    return runs, p


@pytest.mark.parametrize("mode", ["dq", "dq_stats", "dkv"])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 16])
def test_turns_and_split_ring_never_deadlock(mode, n_chunks):
    """The ping-pong protocol of the consumer warpgroups over the ring of
    four split slots, run as a state machine: warpgroup 0's run i, then
    warpgroup 1's run i, then warpgroup 0's run i + 1 (the turns); a run
    waits for its positions to be split and for its item; the splitters
    fill position p once both warpgroups have released p - 4; an item is
    loaded once both have finished their last run that reads the previous
    one. Every run of three items completes."""
    runs, n_pos = _ring_schedule(mode, n_chunks, 3)
    released = {0: set(), 1: set()}
    item_done = {0: set(), 1: set()}
    split, nxt = 0, {0: 0, 1: 0}  # positions split; each warpgroup's next run
    turn = 0
    while min(nxt.values()) < len(runs):
        progressed = False
        # the splitters, in order
        while split < n_pos and (split < 4 or all(split - 4 in released[w] for w in (0, 1))):
            split, progressed = split + 1, True
        w = turn
        if nxt[w] < len(runs):
            it, pos, reads_item, last_t0 = runs[nxt[w]]
            loaded = it == 0 or all(it - 1 in item_done[x] for x in (0, 1))
            if all(x < split for x in pos) and (loaded or not reads_item):
                released[w].update(pos)
                if last_t0:
                    item_done[w].add(it)
                nxt[w] += 1
                turn, progressed = 1 - w, True
        assert progressed, (mode, n_chunks, nxt, split)


@pytest.mark.parametrize("raw_slots,split_slots", [(2, 6), (4, 4), (2, 4)])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("items", [1, 3])
def test_forward_turns_and_rings_never_deadlock(raw_slots, split_slots, n_chunks, items):
    """flash_attention_f32's roles, run as a state machine over `items`
    work items of one block: the TMA thread loads ring position p (per
    chunk K, then V) into a raw slot once the splitters have split p -
    raw_slots; the splitters split p once it is loaded and both consumer
    warpgroups have released p - split_slots; each warpgroup's run r (S of
    chunk r / 2, or P V) waits for position r to be split and for its turn
    (warpgroup 0's run r, warpgroup 1's run r, warpgroup 0's run r + 1),
    and releases r when done. Every run completes, at the ring depths the
    kernel and its A/B variants build."""
    n_pos = 2 * n_chunks * items
    loaded = split = 0
    released = {0: 0, 1: 0}  # positions below this one are released
    turn = 0
    while min(released.values()) < n_pos:
        progressed = False
        if loaded < n_pos and loaded - raw_slots < split:
            loaded, progressed = loaded + 1, True
        if split < loaded and split - split_slots < min(released.values()):
            split, progressed = split + 1, True
        r = released[turn]
        if r < n_pos and r < split:
            released[turn], turn, progressed = r + 1, 1 - turn, True
        assert progressed, (raw_slots, split_slots, n_chunks, items, loaded, split, released)
