"""The arithmetic of the 3xTF32 float32 bodies (csrc/ln_gemm_f32.cu,
csrc/self_attention_f32.cu, csrc/flash_attention_f32.cu), emulated in
numpy on the CPU.

Each float32 operand x runs on Hopper's tensor cores as two TF32 parts,
hi = tf32(x) and lo = tf32(x - hi) (`cvt.rna.tf32.f32`: round to nearest,
ties away from zero, low 13 bits zero), and a product a b as
a_lo b_hi + a_hi b_lo + a_hi b_hi. The tensor cores add each 8-deep
product into their float32 accumulator with truncation; the kernels
therefore sum one K step's products in a fresh partial (32 deep in
ln_gemm_f32, one 64-key chunk in the attention bodies' P V) and add the
partials in float32 with ordinary rounding. Here: the split itself, that
schedule against float64 at the main path's K (768, 3072), in the
attention chain (scores, exact softmax, split P, P V) and in
flash_attention_f32's streaming form of it (an online softmax over 64-key
chunks at 1024 and 4096 keys), within the card's bound of 1e-5 rel-L2
with margin, the softmax's division, and the index maps the kernels use
to feed P to P V and to transpose V (csrc/f32_chunk.cuh; no card
needed)."""

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


def _rz32(x64):
    """float64 -> float32 rounded toward zero (the tensor cores' adds)."""
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_product(a, b, flush=None):
    """a (M, K) @ b (K, N), float32 operands, as the kernels issue it: per
    8-deep step lo b_hi, hi b_lo, hi b_hi, each an exact 8-term sum added
    into a float32 partial with truncation; every `flush` columns of K the
    partial is added into a float32 sum with rounding (None: one chain)."""
    ah, al = tf32_parts(a)
    bh, bl = tf32_parts(b)
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


def _flash_schedule(q, k, v, n):
    """flash_attention_f32.cu's schedule for the query rows q against n keys
    (k, v zero past n up to whole 64-key chunks, as TMA fills them): per
    chunk S = Q K^T in 3xTF32 (one chain), keys past n at -inf, the running
    max m over the chunk's scores, c = exp((m_old - m) / 8), e = exp(s / 8
    - m / 8) in float32, each thread's sum of its 16 keys of a row (keys
    8 j + 2 t4 and + 1) carried as l = l c + sum by FMA; P V in 3xTF32 into
    a fresh partial (one chain per chunk) and O = O c + partial by FMA;
    at the end the quad's four sums added as the shuffles add them, and
    O / l."""
    rows = q.shape[0]
    m = np.full(rows, -np.inf, np.float32)
    l = np.zeros((rows, 4), np.float32)
    o = np.zeros((rows, 64), np.float32)

    def fma(a, b, c):  # a b + c rounded once to float32
        return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)

    for c0 in range(0, k.shape[0], 64):
        s = tc_product(q, k[c0:c0 + 64].T)
        s[:, np.arange(c0, c0 + 64) >= n] = -np.inf
        mx = np.maximum(m, s.max(-1))
        cf = np.exp((m - mx) * np.float32(0.125))
        e = np.exp(fma(s, np.float32(0.125), -mx[:, None].astype(np.float64) * 0.125))
        pairs = e.reshape(rows, 8, 4, 2).sum(-1, dtype=np.float32)  # (rows, j, t4)
        sums = np.zeros((rows, 4), np.float32)
        for j in range(8):
            sums = sums + pairs[:, j]
        l = fma(l, cf[:, None], sums)
        o = fma(o, cf[:, None], tc_product(e, v[c0:c0 + 64]))
        m = mx
    return o / ((l[:, 0] + l[:, 1]) + (l[:, 2] + l[:, 3]))[:, None]


@pytest.mark.parametrize("n", [1024, 4096, 400])
def test_flash_schedule_is_float32_accurate(n):
    """flash_attention_f32's streaming chain for 8 query rows at the 512 px
    and 1024 px token counts and a ragged grid's, against float64."""
    rng = np.random.default_rng(n)
    keys = -(-n // 64) * 64
    q = rng.standard_normal((8, 64)).astype(np.float32)
    k = np.zeros((keys, 64), np.float32)
    v = np.zeros((keys, 64), np.float32)
    k[:n] = rng.standard_normal((n, 64))
    v[:n] = rng.standard_normal((n, 64))
    got = _rel(_flash_schedule(q, k, v, n), _attention_ref(q, k, v, n))
    assert got <= MARGIN * F32_KERNEL_REL_L2, got


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
