"""Card-only checks of the Hopper Montgomery kernels: the multiply, the
modexp, the Karatsuba families' launches, the folds composed of them
(`fold_many`, the resident plane's fused fold, Prism's weighted fold), the
Sanctum decrypt's per-column-modulus product and ladder
(`csrc/mont_rowmod.cu`) with the device plan's full chunk, a host
backend's planes on `[proxy] device`, `configs/default.toml` serving
on the card with Bulwark, the SLO engine and the Watchtower, and
`configs/tenancy.toml` folding two tenants' SumAlls under their own moduli,
the kernel sentry naming `cuda`, and `configs/heliograph.toml`'s probes
on the host beside a user's fold on the card.

Marked `gpu`: on a host without a CUDA device every test here skips (the
decision is made inside the `cuda` fixture, never at import, so every
pytest-xdist worker collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Kernels against their plain PyTorch versions on the same inputs on the
card, folds against Python-int products, modexps against Python `pow`, and
bulk Paillier blinding through the card. Exact integer arithmetic:
tolerance zero.
"""

import random

import numpy as np
import pytest
import torch

from dds_tpu_torch.bench_key import bench_paillier_key
from dds_tpu_torch.models.backend import CpuBackend, CudaBackend
from dds_tpu_torch.ops import bignum as bn
from dds_tpu_torch.ops import mont_cuda
from dds_tpu_torch.ops.montgomery import (
    ModCtx,
    _exp_to_digits,
    carry_edge_moduli,
    carry_edge_operands,
    carry_edge_products,
    karatsuba_edge_operands,
    prod3_edge_columns,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def _residues(ctx: ModCtx, count: int, seed: int) -> np.ndarray:
    """(count, L) uint32 limbs of seeded residues below n: random limbs
    with the top limb drawn below n's top limb."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(count, ctx.L), dtype=np.uint32)
    x[:, -1] = rng.integers(0, int(ctx.N[-1]), size=count, dtype=np.uint32)
    return x


def _n2_ctx() -> ModCtx:
    return ModCtx.make(bench_paillier_key(2048).nsquare)


def test_kernel_matches_plain_at_paillier2048(cuda):
    ctx = _n2_ctx()
    assert ctx.L == 256 and ctx.W == 128
    a = bn.to_device(_residues(ctx, 4096, 1), cuda).T.contiguous()
    b = bn.to_device(_residues(ctx, 4096, 2), cuda).T.contiguous()
    before = mont_cuda.launches.value
    got = mont_cuda.mul(ctx, a, b)
    torch.cuda.synchronize()
    assert mont_cuda.launches.value == before + 1
    want = ctx.mont_mul(a.T, b.T).T
    assert torch.equal(got, want)


def test_kernel_reads_column_slices_of_a_wider_array(cuda):
    ctx = _n2_ctx()
    x = bn.to_device(_residues(ctx, 2 * 1000, 3), cuda).T.contiguous()
    got = mont_cuda.mul(ctx, x[:, :1000], x[:, 1000:2000])
    want = mont_cuda.mul(ctx, x[:, :1000].contiguous(), x[:, 1000:].contiguous())
    assert torch.equal(got, want)
    assert torch.equal(got, ctx.mont_mul(x[:, :1000].T, x[:, 1000:].T).T)


def test_kernel_matches_plain_at_odd_limb_count(cuda):
    rng = random.Random(33)
    n = rng.getrandbits(520) | (1 << 519) | 1
    ctx = ModCtx.make(n)
    assert ctx.L == 33
    a = bn.to_device(_residues(ctx, 300, 4), cuda).T.contiguous()
    b = bn.to_device(_residues(ctx, 300, 5), cuda).T.contiguous()
    assert torch.equal(mont_cuda.mul(ctx, a, b), ctx.mont_mul(a.T, b.T).T)


@pytest.mark.parametrize("K", [1, 5, 33, 8192])
def test_kernel_fold_matches_python_product(cuda, K):
    ctx = _n2_ctx()
    rows = _residues(ctx, K, 10 + K)
    got = mont_cuda.reduce_mul(ctx, bn.to_device(rows, cuda))
    want = 1
    for c in bn.batch_to_ints(rows):
        want = want * c % ctx.n
    assert bn.limbs_to_int(bn.to_host(got)[0]) == want


def test_backend_on_card_matches_host_fold(cuda):
    key = bench_paillier_key(2048)
    n2 = key.nsquare
    rng = random.Random(7)
    cs = [rng.randrange(1, n2) for _ in range(300)]
    be = CudaBackend(min_device_batch=0)
    before = mont_cuda.launches.value
    want = CpuBackend().modmul_fold(cs, n2)
    assert be.modmul_fold_resident(cs, n2) == want
    assert be.modmul_fold_resident(cs, n2) == want
    assert be.modmul_fold(cs, n2) == want
    assert mont_cuda.launches.value - before == 3 * mont_cuda.fold_launches(300)


def test_exp_kernel_matches_plain_at_paillier2048(cuda):
    ctx = _n2_ctx()
    base = ctx.to_mont(bn.to_device(_residues(ctx, 256, 20), cuda)).T.contiguous()
    digits = torch.from_numpy(_exp_to_digits((1 << 63) + 987654321).astype(np.int32)).to(cuda)
    before = mont_cuda.exp_launches.value
    got = mont_cuda.exp(ctx, base, digits)
    torch.cuda.synchronize()
    assert mont_cuda.exp_launches.value == before + 1
    assert torch.equal(got, ctx.mont_exp(base.T, digits).T)


def test_full_width_pow_mod_matches_python_pow(cuda):
    key = bench_paillier_key(2048)
    ctx = ModCtx.make(key.nsquare)
    rows = _residues(ctx, 1024, 21)
    got = bn.to_host(mont_cuda.pow_mod(ctx, bn.to_device(rows, cuda), key.n))
    ints = bn.batch_to_ints(rows)
    for i in random.Random(22).sample(range(1024), 8):
        assert bn.limbs_to_int(got[i]) == pow(ints[i], key.n, key.nsquare)


@pytest.mark.parametrize("exp", [0, 1, 2, 65537])
def test_pow_mod_edge_exponents_and_odd_limb_count(cuda, exp):
    rng = random.Random(40 + exp)
    n = rng.getrandbits(520) | (1 << 519) | 1
    ctx = ModCtx.make(n)
    assert ctx.L == 33
    bases = [rng.randrange(n) for _ in range(5)] + [0, 1, n - 1]
    got = mont_cuda.pow_mod(ctx, bn.to_device(bn.ints_to_batch(bases, ctx.L), cuda), exp)
    assert bn.batch_to_ints(bn.to_host(got)) == [pow(b, exp, n) for b in bases]


def test_backend_powmod_batch_on_card_matches_host(cuda):
    key = bench_paillier_key(2048)
    rng = random.Random(23)
    bases = [rng.randrange(1, key.nsquare) for _ in range(40)] + [key.nsquare + 5]
    be = CudaBackend()
    before = mont_cuda.exp_launches.value
    assert be.powmod_batch(bases, key.n, key.nsquare) == CpuBackend().powmod_batch(
        bases, key.n, key.nsquare)
    assert mont_cuda.exp_launches.value == before + 1


def test_blind_batch_through_the_card_decrypts(cuda):
    key = bench_paillier_key(2048)
    pk = key.public
    rns = pk.blind_batch(64, backend=CudaBackend(), min_batch=1)
    assert len(set(rns)) == 64
    ms = list(range(1000, 1064))
    assert [key.decrypt(pk.encrypt(m, rn=rn)) for m, rn in zip(ms, rns)] == ms


def _lm(ctx: ModCtx, count: int, seed: int, device, rows: int | None = None) -> torch.Tensor:
    """Limbs-major (rows, count) int32 residues below n on `device`."""
    x = bn.to_device(_residues(ctx, count, seed), device).T.contiguous()
    return x if rows is None else x[:rows].contiguous()


def test_prod3_kernel_matches_plain(cuda):
    ctx = _n2_ctx()
    h = ctx.L // 2
    ops = [_lm(ctx, 4096, 60 + i, cuda, rows=h) for i in range(6)]
    before = mont_cuda.prod3_launches.value
    got = mont_cuda.prod3(*ops)
    torch.cuda.synchronize()
    assert mont_cuda.prod3_launches.value == before + 1
    assert torch.equal(got, mont_cuda.prod3(*(x.cpu() for x in ops)).to(cuda))


def test_kfused_and_redc_kernels_match_plain(cuda):
    ctx = _n2_ctx()
    a, b = _lm(ctx, 4096, 70, cuda), _lm(ctx, 4096, 71, cuda)
    before = (mont_cuda.kfused_launches.value, mont_cuda.redc_launches.value)
    T = mont_cuda.prod_kf(a, b)
    out = mont_cuda.redc(ctx, T)
    torch.cuda.synchronize()
    assert (mont_cuda.kfused_launches.value, mont_cuda.redc_launches.value) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(T.cpu(), mont_cuda.prod_kf(a.cpu(), b.cpu()))
    assert torch.equal(out.cpu(), mont_cuda.redc(ctx, T.cpu()))


def test_nofinal_kernel_matches_plain(cuda):
    ctx = _n2_ctx()
    a, b = _lm(ctx, 8192, 72, cuda), _lm(ctx, 8192, 73, cuda)
    before = mont_cuda.nofinal_launches.value
    got = mont_cuda.mul_nofinal(ctx, a, b)
    torch.cuda.synchronize()
    assert mont_cuda.nofinal_launches.value == before + 1
    assert torch.equal(got, ctx.mont_mul_nofinal(a.T, b.T).T)


@pytest.mark.parametrize("mode", ["k1", "fused"])
def test_karatsuba_modes_equal_cios_on_card(cuda, mode):
    ctx = _n2_ctx()
    a, b = _lm(ctx, 4096, 74, cuda), _lm(ctx, 4096, 75, cuda)
    assert torch.equal(mont_cuda.mul(ctx, a, b, karatsuba=mode),
                       mont_cuda.mul(ctx, a, b, karatsuba=False))
    rows = _residues(ctx, 8192, 76)
    got = mont_cuda.reduce_mul(ctx, bn.to_device(rows, cuda), karatsuba=mode)
    want = 1
    for c in bn.batch_to_ints(rows):
        want = want * c % ctx.n
    assert bn.limbs_to_int(bn.to_host(got)[0]) == want


@pytest.mark.parametrize("bits", [520, 576])
def test_karatsuba_modes_route_other_limb_counts_to_cios_on_card(cuda, bits):
    rng = random.Random(bits)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    ctx = ModCtx.make(n)
    assert ctx.L in (33, 36)
    a, b = _lm(ctx, 300, 77, cuda), _lm(ctx, 300, 78, cuda)
    counts = [mont_cuda.LAUNCHES[k].value for k in ("mont_prod3", "mont_kfused", "mont_redc")]
    for mode in ("k1", "fused"):
        assert torch.equal(mont_cuda.mul(ctx, a, b, karatsuba=mode), ctx.mont_mul(a.T, b.T).T)
    torch.cuda.synchronize()
    assert counts == [mont_cuda.LAUNCHES[k].value
                      for k in ("mont_prod3", "mont_kfused", "mont_redc")]


def test_fold_many_on_card_matches_python(cuda):
    from dds_tpu_torch.ops.foldmany import fold_many

    key = bench_paillier_key(2048)
    n2 = key.nsquare
    rng = random.Random(79)
    folds = [[rng.randrange(1, n2) for _ in range(k)] for k in (128, 3, 77)]
    before = mont_cuda.launches.value
    got = fold_many(folds, n2, device=cuda)
    assert mont_cuda.launches.value - before == mont_cuda.fold_launches(128)
    for f, g in zip(folds, got):
        want = 1
        for c in f:
            want = want * c % n2
        assert g == want


def _lm_ints(vals: list[int], rows: int, device) -> torch.Tensor:
    """Limbs-major (rows, len(vals)) int32 of the ints on `device`."""
    return bn.to_device(bn.ints_to_batch(vals, rows), device).T.contiguous()


def _edge_operands(ctx: ModCtx, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every ordered pair of `carry_edge_operands`, limbs-major on `device`."""
    ops = carry_edge_operands(ctx)
    return (_lm_ints([x for x in ops for _ in ops], ctx.L, device),
            _lm_ints([y for _ in ops for y in ops], ctx.L, device))


@pytest.mark.parametrize("L", [33, 256, 512])
def test_mul_and_nofinal_on_carry_edges_match_plain(cuda, L):
    """Moduli of long 0xFFFFFFFF runs and the operands 0, 1, n - 1, R mod n
    and all-ones words: carries and borrows through every lane of the warp
    product, at W = 17, 128 and 256 (WPL = 1, 4, 8)."""
    for n in carry_edge_moduli(L):
        ctx = ModCtx.make(n)
        a, b = _edge_operands(ctx, cuda)
        assert torch.equal(mont_cuda.mul(ctx, a, b), ctx.mont_mul(a.T, b.T).T)
        assert torch.equal(mont_cuda.mul_nofinal(ctx, a, b),
                           ctx.mont_mul_nofinal(a.T, b.T).T)


@pytest.mark.parametrize("L", [33, 256, 512])
def test_exp_on_carry_edges_matches_plain(cuda, L):
    digits = torch.from_numpy(_exp_to_digits(0xF0E1).astype(np.int32)).to(cuda)
    for n in carry_edge_moduli(L):
        ctx = ModCtx.make(n)
        base = bn.to_device(bn.ints_to_batch(carry_edge_operands(ctx), ctx.L), cuda)
        got = mont_cuda.exp(ctx, base.T.contiguous(), digits)
        assert torch.equal(got, ctx.mont_exp(base, digits).T)


@pytest.mark.parametrize("L", [33, 256, 512])
def test_redc_on_carry_edges_matches_plain(cuda, L):
    """The warp REDC on every product of two carry-edge operands and the
    extreme T (0, R - 1, R (n - 1), n R - 1) at W = 17, 128 and 256
    (WPL = 1, 4, 8), then on a column slice of a wider array."""
    for n in carry_edge_moduli(L):
        ctx = ModCtx.make(n)
        Ts = carry_edge_products(ctx)
        T = _lm_ints(Ts, 2 * L, cuda)
        before = mont_cuda.redc_launches.value
        got = mont_cuda.redc(ctx, T)
        torch.cuda.synchronize()
        assert mont_cuda.redc_launches.value == before + 1
        assert torch.equal(got, ctx.redc(T.T).T)
        assert bn.batch_to_ints(bn.to_host(got.T)) == [x * pow(ctx.R, -1, n) % n for x in Ts]
        B = T.shape[1]
        wide = torch.cat([T.flip(1), T], dim=1)
        assert torch.equal(mont_cuda.redc(ctx, wide[:, B:]), got)


@pytest.mark.parametrize("L", [36, 256, 512])
def test_kfused_on_carry_edges_matches_plain(cuda, L):
    """The warp B5 on every ordered pair of the Karatsuba edge operands
    (both half sums overflow on the all-ones operand) at H = 9, 64 and 128
    words a half (HPL = 1, 2, 4; at 256 and 512 a half fills the lanes),
    then on column slices of a wider array."""
    for n in carry_edge_moduli(L):
        ops = karatsuba_edge_operands(ModCtx.make(n))
        xs, ys = [x for x in ops for _ in ops], [y for _ in ops for y in ops]
        a, b = _lm_ints(xs, L, cuda), _lm_ints(ys, L, cuda)
        before = mont_cuda.kfused_launches.value
        got = mont_cuda.prod_kf(a, b)
        torch.cuda.synchronize()
        assert mont_cuda.kfused_launches.value == before + 1
        assert torch.equal(got, mont_cuda.prod_kf(a.cpu(), b.cpu()).to(cuda))
        assert bn.batch_to_ints(bn.to_host(got.T)) == [x * y for x, y in zip(xs, ys)]
        B = a.shape[1]
        wide = torch.cat([a, b], dim=1)
        assert torch.equal(mont_cuda.prod_kf(wide[:, :B], wide[:, B:]), got)


def _prod3_operands(cols: list[tuple[int, ...]], h: int, device) -> tuple[torch.Tensor, ...]:
    """B4's six operands from columns (a0, b0, a1, b1, sa, sb): a0/a1, b0/b1
    and sa/sb as row slices of three (2h, B) tensors, as `prod_k1` passes
    them."""
    a, b, s = (torch.cat([_lm_ints([c[i] for c in cols], h, device) for i in rows])
               for rows in ((0, 2), (1, 3), (4, 5)))
    return a[:h], b[:h], a[h:], b[h:], s[:h], s[h:]


@pytest.mark.parametrize("h", [9, 32, 128, 256])
def test_prod3_on_carry_edges_and_slices_matches_plain(cuda, h):
    """The warp B4 at H = 5, 16, 64, 128 words an operand (HPL = 1, 1, 2,
    4; odd h at 9) on its carry-edge columns and on seeded random ones,
    operands as row slices, then as column slices of wider arrays."""
    rng = random.Random(h)
    cols = prod3_edge_columns(h) + [tuple(rng.getrandbits(16 * h) for _ in range(6))
                                    for _ in range(200)]
    ops = _prod3_operands(cols, h, cuda)
    before = mont_cuda.prod3_launches.value
    got = mont_cuda.prod3(*ops)
    torch.cuda.synchronize()
    assert mont_cuda.prod3_launches.value == before + 1
    assert torch.equal(got, mont_cuda.prod3(*(x.cpu() for x in ops)).to(cuda))
    want = [x * y for c in cols for x, y in ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))]
    blocks = [bn.batch_to_ints(bn.to_host(got[2 * h * p: 2 * h * (p + 1)].T)) for p in range(3)]
    assert [blocks[p][j] for j in range(len(cols)) for p in range(3)] == want
    B = len(cols)
    wide = [torch.cat([x.flip(1), x], dim=1) for x in ops]
    assert torch.equal(mont_cuda.prod3(*(x[:, B:] for x in wide)), got)


@pytest.mark.parametrize("L", [64, 256, 512])
def test_k1_launches_on_carry_edges_match_plain(cuda, L):
    """The half sums and the recombination of mont_k1.cu at H = 16, 64, 128
    words a half on every ordered pair of the Karatsuba edge operands (the
    overflow bits set and clear), against their plain versions, and
    chained through B4 to a*b; then on column slices."""
    for n in carry_edge_moduli(L):
        ops = karatsuba_edge_operands(ModCtx.make(n))
        xs, ys = [x for x in ops for _ in ops], [y for _ in ops for y in ops]
        a, b = _lm_ints(xs, L, cuda), _lm_ints(ys, L, cuda)
        h = L // 2
        before = (mont_cuda.halfsums_launches.value, mont_cuda.combine_launches.value)
        s = mont_cuda.k1_halfsums(a, b)
        z = mont_cuda.prod3(a[:h], b[:h], a[h:], b[h:], s[:h], s[h: 2 * h])
        T = mont_cuda.k1_combine(z, s, L)
        torch.cuda.synchronize()
        assert (mont_cuda.halfsums_launches.value, mont_cuda.combine_launches.value) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(s, mont_cuda.k1_halfsums(a.cpu(), b.cpu()).to(cuda))
        assert torch.equal(T, mont_cuda.k1_combine(z.cpu(), s.cpu(), L).to(cuda))
        assert bn.batch_to_ints(bn.to_host(T.T)) == [x * y for x, y in zip(xs, ys)]
        B = a.shape[1]
        wide = torch.cat([a, b], dim=1)
        assert torch.equal(mont_cuda.k1_halfsums(wide[:, :B], wide[:, B:]), s)
        zw, sw = (torch.cat([x.flip(1), x], dim=1)[:, B:] for x in (z, s))
        assert torch.equal(mont_cuda.k1_combine(zw, sw, L), T)


@pytest.mark.parametrize("bits", [1024, 4096, 8192])
def test_mul_under_k1_equals_mode_0_on_card(cuda, bits):
    """L = 64 (RSA-1024, MultAll's width), 256 and 512; then a mode-1 fold
    of 300 rows against the Python-int product."""
    rng = random.Random(bits)
    ctx = ModCtx.make(rng.getrandbits(bits) | (1 << (bits - 1)) | 1)
    assert ctx.L == bits // 16
    a, b = _lm(ctx, 1000, 80, cuda), _lm(ctx, 1000, 81, cuda)
    assert torch.equal(mont_cuda.mul(ctx, a, b, karatsuba="k1"),
                       mont_cuda.mul(ctx, a, b, karatsuba=False))
    rows = _residues(ctx, 300, 82)
    got = mont_cuda.reduce_mul(ctx, bn.to_device(rows, cuda), karatsuba="k1")
    want = 1
    for c in bn.batch_to_ints(rows):
        want = want * c % ctx.n
    assert bn.limbs_to_int(bn.to_host(got)[0]) == want


def test_mode_1_mul_launches_its_four_kernels_once_each(cuda):
    ctx = _n2_ctx()
    a, b = _lm(ctx, 4096, 83, cuda), _lm(ctx, 4096, 84, cuda)
    names = ("mont_k1_halfsums", "mont_prod3", "mont_k1_combine", "mont_redc", "mont_mul",
             "mont_kfused")
    before = [mont_cuda.LAUNCHES[k].value for k in names]
    mont_cuda.mul(ctx, a, b, karatsuba="k1")
    torch.cuda.synchronize()
    after = [mont_cuda.LAUNCHES[k].value for k in names]
    assert [y - x for x, y in zip(before, after)] == [1, 1, 1, 1, 0, 0]


# ------------------------------------------ L = 64: MultAll at RSA-1024

RSA1024_MODULUS = (1 << 1023) | (0x9E3779B97F4A7C15 << 500) | 0x3B  # L = 64, odd


def _l64_launches(ctx: ModCtx, device) -> dict:
    """Each fold kernel's wrapper and plain version on one B = 4,096 input
    of the fold's shape at L = 64: name -> (kernel call, plain call)."""
    from dds_tpu_torch.ops import montgomery

    L, h = ctx.L, ctx.L // 2
    a, b = _lm(ctx, 4096, 90, device), _lm(ctx, 4096, 91, device)
    s = montgomery.k1_halfsums(a.T, b.T).T.contiguous()
    ops = (a[:h], b[:h], a[h:], b[h:], s[:h], s[h: 2 * h])
    z = montgomery.prod3(*(x.T for x in ops)).T.contiguous()
    T = montgomery.prod(a.T, b.T).T.contiguous()
    return {
        "mont_mul": (lambda: mont_cuda.mul(ctx, a, b, karatsuba=False),
                     lambda: ctx.mont_mul(a.T, b.T).T),
        "mont_prod3": (lambda: mont_cuda.prod3(*ops),
                       lambda: montgomery.prod3(*(x.T for x in ops)).T),
        "mont_k1_halfsums": (lambda: mont_cuda.k1_halfsums(a, b), lambda: s),
        "mont_k1_combine": (lambda: mont_cuda.k1_combine(z, s, L),
                            lambda: montgomery.k1_combine(z.T, s.T, L).T),
        "mont_kfused": (lambda: mont_cuda.prod_kf(a, b),
                        lambda: montgomery.prod_kf(a.T, b.T).T),
        "mont_redc": (lambda: mont_cuda.redc(ctx, T), lambda: ctx.redc(T.T).T),
    }


@pytest.mark.parametrize("name", ["mont_mul", "mont_prod3", "mont_k1_halfsums",
                                  "mont_k1_combine", "mont_kfused", "mont_redc"])
def test_fold_kernels_at_l64_match_plain(cuda, name):
    ctx = ModCtx.make(RSA1024_MODULUS)
    assert ctx.L == 64
    kernel, plain = _l64_launches(ctx, cuda)[name]
    before = mont_cuda.LAUNCHES[name].value
    got = kernel()
    torch.cuda.synchronize()
    assert mont_cuda.LAUNCHES[name].value == before + 1
    assert torch.equal(got, plain())


@pytest.mark.parametrize("mode", [False, "k1", "fused"])
def test_fold_at_l64_equals_python_in_every_mode(cuda, mode):
    ctx = ModCtx.make(RSA1024_MODULUS)
    rows = _residues(ctx, 16384, 92)
    got = mont_cuda.reduce_mul(ctx, bn.to_device(rows, cuda), karatsuba=mode)
    want = 1
    for c in bn.batch_to_ints(rows):
        want = want * c % ctx.n
    assert bn.limbs_to_int(bn.to_host(got)[0]) == want


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_multall_through_the_stack_launches_only_its_modes_kernels(cuda, monkeypatch, mode):
    import asyncio
    import json

    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models.mult import RsaMultKey
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    own = {"0": {"mont_mul"},
           "1": {"mont_prod3", "mont_k1_halfsums", "mont_k1_combine", "mont_redc"},
           "2": {"mont_kfused", "mont_redc"}}[mode]
    folds = ("mont_mul", "mont_prod3", "mont_k1_halfsums", "mont_k1_combine", "mont_kfused",
             "mont_redc")
    rsa = RsaMultKey.generate(1024)
    plains = list(range(2, 302))
    monkeypatch.setenv("DDS_KARATSUBA", mode)

    async def go():
        cfg = DDSConfig()
        cfg.proxy.min_device_batch = 0
        dep = await launch(cfg)
        port = dep.server.cfg.port
        try:
            for i, m in enumerate(plains):
                row = [i, "x", "1", str(rsa.public.encrypt(m))]
                st, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                           json.dumps({"contents": row}).encode())
                assert st == 200
            torch.cuda.synchronize()
            before = {k: mont_cuda.LAUNCHES[k].value for k in folds}
            st, body = await http_request("127.0.0.1", port, "GET",
                                          f"/MultAll?position=3&pubkey={rsa.n}")
            torch.cuda.synchronize()
            after = {k: mont_cuda.LAUNCHES[k].value for k in folds}
        finally:
            await dep.stop()
        assert st == 200
        return int(json.loads(body)["result"]), {k: after[k] - before[k] for k in folds}

    result, launched = asyncio.run(go())
    want = 1
    for m in plains:
        want = want * m % rsa.n
    assert rsa.decrypt(result) == want
    assert {k for k, v in launched.items() if v > 0} == own


# ------------------------------------------- the resident plane and Stratum


MODE_FOLD_KERNELS = {"0": {"mont_mul"},
                     "1": {"mont_prod3", "mont_k1_halfsums", "mont_k1_combine", "mont_redc"},
                     "2": {"mont_kfused", "mont_redc"}}


def _ints(ctx: ModCtx, count: int, seed: int) -> list[int]:
    return bn.batch_to_ints(_residues(ctx, count, seed))


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_fused_fold_on_card_equals_plain_plane_and_python(cuda, monkeypatch, mode):
    """S = 4 groups, K = 8,192: the plane on the card, the same plane on
    the CPU (the plain PyTorch path) and the Python-int product agree; the
    fold launches its mode's kernels only, 14 mont_mul launches in mode 0
    (11 local levels, 2 tail levels, the fix)."""
    from dds_tpu_torch.resident import ResidentPlane

    monkeypatch.setenv("DDS_KARATSUBA", mode)
    ctx = _n2_ctx()
    ops = _ints(ctx, 8192, 80)
    parts = [(f"s{g}", ops[g * 2048: (g + 1) * 2048]) for g in range(4)]
    card = CudaBackend(min_device_batch=0).resident_plane(256, 65536)
    want = 1
    for c in ops:
        want = want * c % ctx.n
    assert card.fold_groups(parts, ctx.n) == want  # ingest
    torch.cuda.synchronize()
    before = {k: c.value for k, c in mont_cuda.LAUNCHES.items()}
    assert card.fold_groups(parts, ctx.n) == want
    torch.cuda.synchronize()
    launched = {k: c.value - before[k] for k, c in mont_cuda.LAUNCHES.items()}
    assert {k for k, v in launched.items() if v} == MODE_FOLD_KERNELS[mode]
    if mode == "0":
        assert launched["mont_mul"] == 14
    assert all(p.device.type == "cuda" for p in (card.pool(g, ctx.n) for g, _ in parts))
    plain = ResidentPlane(device="cpu", initial_rows=256, max_rows=65536)
    small = [(g, o[:96]) for g, o in parts]  # the plain path at a CPU-sized width
    assert plain.fold_groups(small, ctx.n) == card.fold_groups(small, ctx.n)


def test_eviction_on_card_spills_the_host_rows(cuda):
    """An eviction wave on a cuda pool spills (cipher, uint32 row) pairs
    equal to the host conversion of each cipher, and the compacted
    buffer on the card holds the survivors in index order."""
    from dds_tpu_torch.resident import ResidentPool

    ctx = _n2_ctx()
    spilled = []
    pool = ResidentPool(ctx.n, initial_rows=64, max_rows=256, device="cuda",
                        spill=spilled.extend)
    waves = [_ints(ctx, 96, 90 + i) for i in range(4)]
    for w in waves:
        assert pool.ingest(w) == 96
    assert pool.resets == 0 and pool.epoch > 0 and spilled
    for c, row in spilled:
        assert row.dtype == np.uint32 and row.shape == (ctx.L,)
        np.testing.assert_array_equal(row, bn.int_to_limbs(c, ctx.L))
    survivors = sorted(pool._index, key=pool._index.get)
    assert pool._buf.device.type == "cuda"
    np.testing.assert_array_equal(bn.to_host(pool._buf[: pool.resident]),
                                  bn.ints_to_batch(survivors, ctx.L))
    everything = [c for w in waves for c in w]
    assert set(everything) == set(survivors) | {c for c, _ in spilled}
    assert pool.fold(waves[-1]) == _pyfold(waves[-1], ctx.n)


def _pyfold(cs, n):
    acc = 1
    for c in cs:
        acc = acc * c % n
    return acc


def test_stratum_streamed_leg_on_card(cuda, tmp_path):
    """A tiered fold on a cuda plane: the resident leg and the streamed
    warm, cold and direct legs (mont_cuda.reduce_mul on the card) merge to
    the Python-int product, with no reset."""
    from dds_tpu_torch.storage import Stratum

    ctx = _n2_ctx()
    plane = CudaBackend(min_device_batch=0).resident_plane(64, 256)
    stratum = Stratum(plane, tmp_path, warm_bytes=64 * ctx.L * 4, chunk_rows=64)
    pop = _ints(ctx, 1024, 95)
    before = mont_cuda.launches.value
    assert stratum.fold_groups([("g", pop)], ctx.n) == _pyfold(pop, ctx.n)
    tail = pop[-200:]
    assert stratum.fold_groups([("g", tail)], ctx.n) == _pyfold(tail, ctx.n)
    torch.cuda.synchronize()
    assert mont_cuda.launches.value > before
    s = stratum.stats()
    assert s["cold_reads"] > 0 and s["tiers"]["cold"]["rows"] > 0
    assert plane.pool("g", ctx.n).resets == 0


@pytest.mark.parametrize("mode", ["0", "1", "2"])
@pytest.mark.parametrize("key_bits", [512, 2048])
def test_fold_weighted_on_card_equals_plain_and_python(cuda, monkeypatch, mode, key_bits):
    """Prism's weighted fold mod n^2 at L = 64 and 256: K = 37 operands,
    R = 5 rows (both pads), 16-bit weights, a zero row and one 64-bit
    weight (D = 16) on the card equal the same call on the CPU (the plain
    PyTorch path) and the Python-int products."""
    from dds_tpu_torch.models.backend import _host_matvec
    from dds_tpu_torch.ops.foldmany import fold_weighted

    monkeypatch.setenv("DDS_KARATSUBA", mode)
    n2 = bench_paillier_key(key_bits).nsquare
    ctx = ModCtx.make(n2)
    assert ctx.L == key_bits // 8
    cs = _ints(ctx, 37, 81)
    rng = random.Random(82)
    weights = [[rng.randrange(1 << 16) for _ in range(37)] for _ in range(5)]
    weights[3] = [0] * 37
    weights[1][7] = (1 << 64) - 1
    got = fold_weighted(cs, weights, n2, device=cuda)
    assert got == fold_weighted(cs, weights, n2, device="cpu")
    assert got == _host_matvec(cs, weights, n2)
    assert got[3] == 1


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_fold_weighted_launches_the_ladders_count(cuda, monkeypatch, mode):
    """One weighted fold at K = 8,192 with 16-bit weights (D = 4) makes
    1 + 14 + 4 (4 + 13 + 1) + 1 = 88 products: 88 mont_mul launches in
    mode 0; in modes 1 and 2 each product is its family's launches plus
    one REDC, 88 of each; no other fold kernel."""
    from dds_tpu_torch.ops.foldmany import fold_weighted, fold_weighted_launches

    monkeypatch.setenv("DDS_KARATSUBA", mode)
    n2 = bench_paillier_key(2048).nsquare
    ctx = ModCtx.make(n2)
    cs = _ints(ctx, 8192, 83)
    rng = np.random.default_rng(84)
    weights = rng.integers(0, 1 << 16, size=(2, 8192)).tolist()
    weights[0][0] = 0xF000  # the longest weight has 16 bits: D = 4
    torch.cuda.synchronize()
    before = {k: c.value for k, c in mont_cuda.LAUNCHES.items()}
    got = fold_weighted(cs, weights, n2, device=cuda)
    torch.cuda.synchronize()
    launched = {k: c.value - before[k] for k, c in mont_cuda.LAUNCHES.items()}
    assert fold_weighted_launches(8192, 4) == 88
    assert {k: v for k, v in launched.items() if v} == dict.fromkeys(MODE_FOLD_KERNELS[mode], 88)
    small = [r[:64] for r in weights]
    assert fold_weighted(cs[:64], small, n2, device=cuda) == fold_weighted(
        cs[:64], small, n2, device="cpu")
    assert len(got) == 2


# ------------------------------------------------ the search plane's predicate ops


def _predicate_column(n: int, seed: int):
    """n packable OPE-like values (ties, the lane edges) and digest words."""
    from dds_tpu_torch.ops import predicate as pr

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, pr.PACK_MAX + 1, size=n // 16)
    vals = [int(v) for v in np.where(rng.random(n) < 0.5,
                                     rng.integers(0, pr.PACK_MAX + 1, size=n),
                                     rng.choice(pool, size=n))]
    vals[:4] = [0, pr.LANE_MASK, pr.LANE_MASK + 1, pr.PACK_MAX]
    words = [f"w{int(x)}" for x in rng.integers(0, n // 8, size=n)]
    return vals, words


@pytest.mark.parametrize("op", ["compare", "range", "eq", "entry", "sort"])
def test_predicate_ops_on_the_card_equal_the_cpu_at_65536(cuda, op):
    """Each of the five predicate ops on CUDA lane tensors at N = 65,536
    (one full resident pool's rows) against the same op on the CPU:
    identical masks and permutations, the result on the card."""
    from dds_tpu_torch.ops import predicate as pr

    vals, words = _predicate_column(65536, 91)
    cpu = torch.device("cpu")
    hi, lo = pr.pack_ints(vals, cpu)
    dhi, dlo = pr.pack_digests(words, cpu)
    dev = {k: t.to(cuda) for k, t in (("hi", hi), ("lo", lo), ("dhi", dhi), ("dlo", dlo))}
    cases = {
        "compare": [(lambda d, h, l, o=o, t=t: pr.compare_mask(h, l, o, t, device=d))
                    for o in ("gt", "ge", "lt", "le") for t in (vals[9], vals[4] | 1, 0)],
        "range": [lambda d, h, l: pr.range_mask(h, l, vals[5], vals[6] | pr.LANE_MASK,
                                                 device=d)],
        "sort": [(lambda d, h, l, desc=desc: pr.sort_perm(h, l, desc, device=d))
                 for desc in (False, True)],
    }
    if op in cases:
        for fn in cases[op]:
            got = fn(cuda, dev["hi"], dev["lo"])
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), fn(cpu, hi, lo))
        return
    if op == "eq":
        for q in (words[3], "absent"):
            got = pr.eq_mask(dev["dhi"], dev["dlo"], q, device=cuda)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), pr.eq_mask(dhi, dlo, q, device=cpu))
        return
    width = 8
    mh = dhi.reshape(-1, width)
    ml = dlo.reshape(-1, width)
    valid = torch.rand(mh.shape, generator=torch.Generator().manual_seed(5)) < 0.8
    for queries, mode in (([words[0]], "any"), (words[1:4], "any"), (words[:2], "all")):
        got = pr.entry_mask(mh.to(cuda), ml.to(cuda), valid.to(cuda), queries, mode,
                            device=cuda)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), pr.entry_mask(mh, ml, valid, queries, mode, device=cpu))


# -------------------------------------------- one modulus a column (Sanctum)

def _rowmod_columns(moduli: list[int], L: int, seed: int, E: int):
    """Limbs-major operands a, b below each column's modulus, the column
    constants (`mont_cuda.rowmod_args`) and (E', B) digit columns of
    exponents of unequal lengths (up to E digits, leading zeros)."""
    rng = np.random.default_rng(seed)
    a = [int.from_bytes(rng.bytes(2 * L), "little") % n for n in moduli]
    b = [int.from_bytes(rng.bytes(2 * L), "little") % n for n in moduli]
    lens = rng.integers(1, E + 1, size=len(moduli))
    digits = np.zeros((E, len(moduli)), np.int32)
    for i, k in enumerate(lens):
        digits[E - k:, i] = rng.integers(0, 16, size=k)
    return a, b, digits


def _rowmod_parity(cuda, moduli: list[int], L: int, seed: int, E: int) -> None:
    from dds_tpu_torch.ops.bignum import ints_to_batch

    a, b, digits = _rowmod_columns(moduli, L, seed, E)
    A = bn.to_device(ints_to_batch(a, L), cuda).T.contiguous()
    Bt = bn.to_device(ints_to_batch(b, L), cuda).T.contiguous()
    N32, n0, one = mont_cuda.rowmod_args(moduli, L, cuda)
    D = torch.from_numpy(digits).to(cuda)
    before = (mont_cuda.mul_rowmod_launches.value, mont_cuda.exp_rowmod_launches.value)
    got_mul = mont_cuda.mul_rowmod(A, Bt, N32, n0)
    got_exp = mont_cuda.exp_rowmod(A, D, one, N32, n0)
    torch.cuda.synchronize()
    assert (mont_cuda.mul_rowmod_launches.value, mont_cuda.exp_rowmod_launches.value) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got_mul, mont_cuda.mul_rowmod_plain(A, Bt, N32, n0))
    assert torch.equal(got_exp, mont_cuda.exp_rowmod_plain(A, D, one, N32, n0))


def test_rowmod_kernels_match_plain_at_the_crt_shape(cuda):
    """L = 128 (Paillier-2048's p^2 and q^2), B = 8,192 columns: two
    seeded odd 2,048-bit moduli alternating by column block as the fused
    decrypt stacks them, per-column digits of unequal lengths."""
    rng = np.random.default_rng(61)
    two = [int.from_bytes(rng.bytes(256), "little") | 1 | (1 << 2047) for _ in range(2)]
    _rowmod_parity(cuda, [two[0]] * 4096 + [two[1]] * 4096, 128, 62, 12)


@pytest.mark.parametrize("L", [33, 128, 256])
def test_rowmod_kernels_on_carry_edge_moduli(cuda, L):
    """A different carry-edge modulus (or a seeded one) in every column."""
    rng = np.random.default_rng(L)
    mods = carry_edge_moduli(L) + [int.from_bytes(rng.bytes(2 * L), "little")
                                   | 1 | (1 << (16 * L - 1)) for _ in range(61)]
    _rowmod_parity(cuda, mods, L, L + 1, 20)


def test_rowmod_kernels_read_column_slices(cuda):
    from dds_tpu_torch.ops.bignum import ints_to_batch

    L, rng = 128, np.random.default_rng(63)
    mods = [int.from_bytes(rng.bytes(256), "little") | 1 | (1 << 2047) for _ in range(96)]
    a, b, digits = _rowmod_columns(mods, L, 64, 8)
    A = bn.to_device(ints_to_batch(a + a, L), cuda).T.contiguous()
    Bt = bn.to_device(ints_to_batch(b, L), cuda).T.contiguous()
    N32, n0, one = mont_cuda.rowmod_args(mods, L, cuda)
    D = torch.from_numpy(np.concatenate([digits, digits], axis=1)).to(cuda)
    assert torch.equal(mont_cuda.mul_rowmod(A[:, 96:], Bt, N32, n0),
                       mont_cuda.mul_rowmod(A[:, :96].contiguous(), Bt, N32, n0))
    assert torch.equal(mont_cuda.exp_rowmod(A[:, 96:], D[:, 96:], one, N32, n0),
                       mont_cuda.exp_rowmod(A[:, :96].contiguous(), D[:, :96].contiguous(),
                                            one, N32, n0))


def test_sanctum_device_plan_decrypts_a_full_chunk_on_the_card(cuda):
    """One 4,096-ciphertext chunk of the device plan (1,024-bit key, so the
    host check stays short): every plaintext back, exactly 2
    `mont_mul_rowmod` and 1 `mont_exp_rowmod` launches and no other
    kernel; `_fused_crt` on the card equals its plain path on the CPU."""
    from dds_tpu_torch.sanctum import SecretBackend, plan_for
    from dds_tpu_torch.sanctum.device import _fused_crt

    key = bench_paillier_key(1024)
    rng = np.random.default_rng(65)
    ms = [int(x) for x in rng.integers(0, 1 << 48, size=4096)]
    blinds = [key.public.blind() for _ in range(8)]
    cts = [key.public.encrypt(m, rn=blinds[i % 8]) for i, m in enumerate(ms)]
    plan = plan_for(key, SecretBackend(device=True))
    for c in mont_cuda.LAUNCHES.values():
        c.reset()
    assert plan.decrypt_batch(cts) == ms
    counts = {k: c.value for k, c in mont_cuda.LAUNCHES.items() if c.value}
    assert counts == {"mont_mul_rowmod": 2, "mont_exp_rowmod": 1}
    bases = plan._marshal(cts[:16], 16)
    consts = [torch.from_numpy(a) for a in (plan._N, plan._n0, plan._R2, plan._one,
                                            plan._digits)]
    x = bn.to_device(bases, "cpu").T.contiguous()
    got = _fused_crt(x.to(cuda), *(c.to(cuda) for c in consts))
    assert torch.equal(got.cpu(), _fused_crt(x, *consts))
    key.scrub()
    assert plan.closed


def test_sumall_on_the_card_across_a_byzantine_recovery(cuda):
    """default.toml's [replicas] (9 endpoints, 2 spares, quorum 5) on a
    `cuda` stack with [attacks] enabled: Trudy compromises f = 2 replicas
    and a SumAll taken while the supervisor recovers the first victim
    folds on B1 (mont_mul) and equals the Python-int fold of the stored
    Paillier-2048 ciphertexts, before and during the recovery."""
    import asyncio
    import json

    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    key = bench_paillier_key(2048)
    pk = key.public
    blinds = [pk.blind() for _ in range(8)]
    rows = [[i, f"n{i}", pk.encrypt(i + 1, rn=blinds[i % 8])] for i in range(256)]
    fold = 1
    for r in rows:
        fold = fold * r[2] % pk.nsquare
    cfg = DDSConfig.from_dict({
        "replicas": {"endpoints": [f"replica-{i}" for i in range(9)],
                     "sentinent": ["replica-7", "replica-8"],
                     "byz-quorum-size": 5, "byz-max-faults": 2},
        "recovery": {"enabled": True, "warm-up": 60.0, "interval": 60.0,
                     "sentinent-awake-timeout": 1.0, "manifest-timeout": 1.0},
        "proxy": {"crypto-backend": "cuda", "device": "cuda", "min-device-batch": 0},
        "attacks": {"enabled": True},
    })

    async def go():
        dep = await launch(cfg)
        try:
            port = dep.server.cfg.port
            for r in rows:
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": r}).encode())
                assert status == 200
            target = f"/SumAll?position=2&nsqr={pk.nsquare}"
            await dep.net.quiesce()
            dep.trudy._rng = random.Random(21)
            victims = dep.trudy.trigger("byzantine")
            await dep.net.quiesce()
            for c in mont_cuda.LAUNCHES.values():
                c.reset()
            rec = asyncio.ensure_future(dep.supervisor.recover(victims[0]))
            await asyncio.sleep(0)
            in_flight = not dep.supervisor._idle.is_set()
            status, body = await http_request("127.0.0.1", port, "GET", target)
            await rec
            torch.cuda.synchronize()
            return in_flight, status, int(json.loads(body)["result"]), \
                mont_cuda.LAUNCHES["mont_mul"].value, victims, \
                [a for a, _ in dep.supervisor.active]
        finally:
            await dep.stop()

    in_flight, status, result, launches, victims, active = asyncio.run(
        asyncio.wait_for(go(), 240))
    assert in_flight and status == 200
    assert result == fold and key.decrypt(result) == 256 * 257 // 2
    assert launches > 0
    assert victims[0] not in active


def test_host_backend_planes_on_the_card(cuda):
    """A `crypto-backend = "cpu"` proxy with [resident] and [search] and
    `[proxy] device = "cuda"` builds both planes on the card."""
    from dds_tpu_torch.core.quorum_client import AbdClient, AbdClientConfig
    from dds_tpu_torch.core.transport import InMemoryNet
    from dds_tpu_torch.http.server import DDSRestServer, ProxyConfig
    from dds_tpu_torch.utils.config import ResidentConfig, SearchConfig

    abd = AbdClient("proxy-0", InMemoryNet(), ["replica-0"], AbdClientConfig())
    server = DDSRestServer(abd, ProxyConfig(
        crypto_backend="cpu", device="cuda",
        resident=ResidentConfig(enabled=True, initial_rows=4, max_rows=64),
        search=SearchConfig(enabled=True)))
    assert server.backend.name == "cpu"
    assert server._resident.device.type == server._search.device.type == "cuda"
    pool = server._resident.pool("", 7 * 11 * 13)
    assert pool._buf.device.type == "cuda"


def test_default_toml_serves_on_the_card_with_bulwark_slo_and_watchtower(cuda):
    """configs/default.toml with `crypto-backend = "cuda"` on the card
    (9 endpoints, 2 spares, quorum 5; [admission], the audit and /slo on as
    the file says): a burst of background-class requests past that class's
    bucket (32) answers 429 with the refill Retry-After and the admission
    body; PutSets and a SumAll folding on B1 that equals the Python-int
    fold; 200 concurrent SumAlls, each answer exact or refused at the edge
    (429 while the aggregate bucket is dry, 503 once the ratchet sheds
    aggregates, with Retry-After and the admission body), none a 500;
    /slo parses, the Watchtower audited ops with no violation, and `stop`
    detaches it."""
    import asyncio
    import json
    import pathlib

    from dds_tpu_torch.http.miniserver import http_request, http_request_full
    from dds_tpu_torch.obs.watchtower import watchtower
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    key = bench_paillier_key(2048)
    pk = key.public
    blinds = [pk.blind() for _ in range(8)]
    rows = [[i, f"n{i}", pk.encrypt(i + 1, rn=blinds[i % 8])] for i in range(256)]
    fold = 1
    for r in rows:
        fold = fold * r[2] % pk.nsquare
    root = pathlib.Path(__file__).resolve().parent.parent
    cfg = DDSConfig.load(root / "configs" / "default.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.min_device_batch = 0

    async def go():
        dep = await launch(cfg)
        try:
            port = dep.server.cfg.port
            # an idle edge: the background bucket's burst, then 429s
            burst = await asyncio.gather(*(http_request_full(
                "127.0.0.1", port, "GET", "/_sync") for _ in range(48)))
            for r in rows:
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": r}).encode())
                assert status == 200
            target = f"/SumAll?position=2&nsqr={pk.nsquare}"
            for c in mont_cuda.LAUNCHES.values():
                c.reset()
            status, body = await http_request("127.0.0.1", port, "GET", target)
            torch.cuda.synchronize()
            launches = mont_cuda.LAUNCHES["mont_mul"].value
            flood = await asyncio.gather(*(http_request_full(
                "127.0.0.1", port, "GET", target, timeout=120.0) for _ in range(200)))
            await dep.net.quiesce()
            _, slo = await http_request("127.0.0.1", port, "GET", "/slo")
            return burst, status, int(json.loads(body)["result"]), launches, flood, \
                json.loads(slo), dep.server.backend.device.type
        finally:
            await dep.stop()

    burst, status, result, launches, flood, slo, device = asyncio.run(
        asyncio.wait_for(go(), 300))
    throttled = [(h, b) for s, h, b in burst if s == 429]
    assert {s for s, _, _ in burst} == {404, 429} and len(throttled) <= 16
    assert all(h["retry-after"] == "1" and b.startswith(b"admission rejected")
               for h, b in throttled)
    assert device == "cuda" and status == 200 and launches > 0
    assert result == fold and key.decrypt(result) == 256 * 257 // 2
    refused = [(s, h) for s, h, b in flood if b.startswith(b"admission rejected")]
    assert all(s in (429, 503) and int(h["retry-after"]) >= 1 for s, h in refused)
    # any other 503 is a degraded answer (the budget ran out under the
    # flood), never a 500
    assert all(s in (200, 429) or (s == 503 and "retry-after" in h) for s, h, _ in flood)
    assert all(int(json.loads(b)["result"]) == fold for s, _, b in flood if s == 200)
    assert slo["audit"]["ops_audited"] > 0 and slo["audit"]["violations"] == {}
    assert "SumAll" in slo["slo"]["routes"] and "admission" in slo
    assert not watchtower.attached


def test_tenancy_toml_folds_each_tenants_sumall_under_its_own_modulus(cuda):
    """configs/tenancy.toml on the card (`crypto-backend = "cuda"`): two
    tenants, each with its own Paillier-2048 family from a
    `TenantKeyring`, PutSet 256 rows each (blinded on the card, B3); each
    tenant's SumAll under its own n^2 folds exactly its own rows on B1 (a
    launch count of its own each) and decrypts to its plaintext total,
    and the backend holds one device store a modulus."""
    import asyncio
    import json
    import pathlib

    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.models.tenancy import TenantKeyring
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    kr = TenantKeyring(paillier_bits=2048, rsa_bits=1024)
    tenants = ("gold", "batch-etl")
    rng = np.random.default_rng(15)
    plain = {t: [int(x) for x in rng.integers(0, 1 << 30, 256)] for t in tenants}
    root = pathlib.Path(__file__).resolve().parent.parent
    cfg = DDSConfig.load(root / "configs" / "tenancy.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.port = 0
    cfg.proxy.min_device_batch = 0

    async def go():
        dep = await launch(cfg)
        be = dep.server.backend
        try:
            port = dep.server.cfg.port
            cts = {t: kr.keys_for(t).psse.public.encrypt_batch(plain[t], be) for t in tenants}
            for t in tenants:
                for c in cts[t]:
                    status, _ = await http_request(
                        "127.0.0.1", port, "POST", "/PutSet",
                        json.dumps({"contents": [str(c)]}).encode(),
                        headers={"x-dds-tenant": t})
                    assert status == 200
            out = {}
            for t in tenants:
                n2 = kr.keys_for(t).psse.nsquare
                for c in mont_cuda.LAUNCHES.values():
                    c.reset()
                status, body = await http_request(
                    "127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={n2}",
                    headers={"x-dds-tenant": t}, timeout=120.0)
                torch.cuda.synchronize()
                out[t] = (status, int(json.loads(body)["result"]),
                          mont_cuda.LAUNCHES["mont_mul"].value)
            return cts, out, len(be._stores), be.device.type
        finally:
            await dep.stop()

    cts, out, stores, device = asyncio.run(asyncio.wait_for(go(), 300))
    assert device == "cuda" and stores >= 2
    for t in tenants:
        n2 = kr.keys_for(t).psse.nsquare
        fold = 1
        for c in cts[t]:
            fold = fold * c % n2
        status, result, launches = out[t]
        assert status == 200 and result == fold and launches > 0
        assert kr.decrypt(t, result) == sum(plain[t])


def test_sentry_names_cuda_for_the_cards_kernel_spans(cuda, monkeypatch):
    """After a fold on the card the sentry's platform is `cuda` and every
    row it collects from the kprof spans is a `cuda::` row."""
    from dds_tpu_torch.obs import sentry
    from dds_tpu_torch.utils.trace import tracer

    monkeypatch.delenv("DDS_SENTRY_PLATFORM", raising=False)
    key = bench_paillier_key(2048)
    rng = random.Random(16)
    cs = [rng.randrange(1, key.nsquare) for _ in range(512)]
    tracer.reset()
    be = CudaBackend(device=cuda, min_device_batch=0)
    assert be.modmul_fold_resident(cs, key.nsquare) == _pyfold(cs, key.nsquare)
    be.powmod_batch(cs[:64], key.n, key.nsquare)
    stats = sentry.collect()
    assert sentry.platform() == "cuda" and stats
    assert all(k.startswith("cuda::") for k in stats), sorted(stats)
    assert any(k.startswith("cuda::pow") for k in stats)


def test_heliograph_toml_probes_on_the_host_beside_a_user_fold_on_the_card(cuda, monkeypatch):
    """configs/heliograph.toml on the card (`crypto-backend = "cuda"`), the
    prober's cycles driven on its loopback target with its own 512-bit
    keys (east and west fail without a lookup): every probe kind reads ok
    and launches no B1; a user's SumAll over 256 rows of the bench key
    folds on B1 and is the Python fold; the next cycle is ok again and
    launches no B1."""
    import asyncio
    import json
    import pathlib
    import socket

    from dds_tpu_torch.clt import canary
    from dds_tpu_torch.http.miniserver import http_request
    from dds_tpu_torch.obs.heliograph import Heliograph
    from dds_tpu_torch.run import launch
    from dds_tpu_torch.utils.config import DDSConfig

    real = canary.http_request

    async def transport(host, port, *a, **kw):
        if host in ("proxy-east", "proxy-west"):
            raise socket.gaierror(socket.EAI_NONAME, "Name or service not known")
        return await real(host, port, *a, **kw)

    async def idle(self):
        await asyncio.Event().wait()

    monkeypatch.setattr(canary, "http_request", transport)
    monkeypatch.setattr(Heliograph, "_run", idle)
    root = pathlib.Path(__file__).resolve().parent.parent
    cfg = DDSConfig.load(root / "configs" / "heliograph.toml")
    cfg.proxy.crypto_backend = "cuda"
    cfg.proxy.port = 0
    key = bench_paillier_key(2048)
    rng = random.Random(16)
    plain = [rng.randrange(1 << 30) for _ in range(256)]

    async def go():
        dep = await launch(cfg)
        try:
            h, port = dep.server.heliograph, dep.server.cfg.port
            h.client = canary.CanaryClient(
                await canary.build_provider(cfg.heliograph.paillier_bits,
                                            cfg.heliograph.rsa_bits),
                population=cfg.heliograph.population)
            launches = []

            async def probe_cycle():
                for c in mont_cuda.LAUNCHES.values():
                    c.reset()
                await h.run_cycle(h.targets[0])
                h.cycles += 1
                torch.cuda.synchronize()
                launches.append(mont_cuda.LAUNCHES["mont_mul"].value)
                return sorted((k, r.verdict) for k, r in h.ledger._last.items())

            first = await probe_cycle()
            cts = [key.public.encrypt(m) for m in plain]
            for c in cts:
                status, _ = await http_request("127.0.0.1", port, "POST", "/PutSet",
                                               json.dumps({"contents": [str(c)]}).encode())
                assert status == 200
            for c in mont_cuda.LAUNCHES.values():
                c.reset()
            status, body = await http_request(
                "127.0.0.1", port, "GET", f"/SumAll?position=0&nsqr={key.nsquare}",
                timeout=120.0)
            torch.cuda.synchronize()
            user = (status, int(json.loads(body)["result"]),
                    mont_cuda.LAUNCHES["mont_mul"].value)
            second = await probe_cycle()
            return first, second, user, launches, dep.server.backend.device.type, cts
        finally:
            await dep.stop()

    first, second, (status, result, user_launches), probe_launches, device, cts = asyncio.run(
        asyncio.wait_for(go(), 300))
    kinds = [(k, "ok") for k in ("matvec", "mult", "putget", "search", "sum")]
    assert device == "cuda" and first == second == kinds
    assert probe_launches == [0, 0] and user_launches > 0
    assert status == 200 and result == _pyfold(cts, key.nsquare)
    assert key.decrypt(result) == sum(plain)


# ------------------------------------------------------------- the mesh


@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_sharded_fold_on_card_slots_equals_the_flat_fold(cuda, D, ring):
    """`sharded_reduce_mul_fixed` over D slots of the one card: bit for
    bit the flat fold and the Python product, one B1 launch a level a slot
    plus the combine and the fix."""
    from dds_tpu_torch.parallel import Mesh
    from dds_tpu_torch.parallel import mesh as pm

    ctx = _n2_ctx()
    host = _residues(ctx, 1000, 40 + D)
    rows = bn.to_device(host, cuda)
    flat = mont_cuda.reduce_mul(ctx, rows, karatsuba=False)
    before = mont_cuda.launches.value
    out = pm.sharded_reduce_mul_fixed(ctx, rows, Mesh([cuda] * D), ring=ring)
    torch.cuda.synchronize()
    n_mul = pm.mesh_fold_launches([[-(-1000 // D)]] * D, ring)
    assert mont_cuda.launches.value - before == n_mul
    assert torch.equal(out, flat)
    want = 1
    for c in bn.batch_to_ints(host):
        want = want * c % ctx.n
    assert bn.limbs_to_int(bn.to_host(out)[0]) == want


def test_mesh_backend_and_plane_on_card(cuda):
    """`CudaBackend(mesh=Mesh([cuda] * 4))`: the padded sharded modexp
    equals Python `pow`, and the resident plane's multi-device fold over 4
    groups equals the Python product with its launch formula."""
    from dds_tpu_torch.parallel import Mesh
    from dds_tpu_torch.parallel.mesh import mesh_fold_launches

    key = bench_paillier_key(2048)
    n2 = key.nsquare
    rng = random.Random(21)
    be = CudaBackend(min_device_batch=0, mesh=Mesh([cuda] * 4))
    bases = [rng.randrange(n2) for _ in range(10)]
    assert be.powmod_batch(bases, key.n, n2) == [pow(b, key.n, n2) for b in bases]
    parts = [(f"s{g}", [rng.randrange(1, n2) for _ in range(300 + g)]) for g in range(4)]
    plane = be.resident_plane(256, 65536)
    want = 1
    for _, ops in parts:
        for c in ops:
            want = want * c % n2
    assert plane.fold_groups(parts, n2) == want
    before = mont_cuda.launches.value
    assert plane.fold_groups(parts, n2) == want
    torch.cuda.synchronize()
    assert mont_cuda.launches.value - before == mesh_fold_launches([[300], [301], [302], [303]])
    assert plane.stats()["mesh_devices"] == 4
