"""The GroupNorm kernels of the port, float32 on the CPU: the one-launch
kernel's plain version against the JAX Pallas ``_kernel`` (interpret mode)
and ``_reference_impl``, and its route rule at the shapes of the ported
models; the ``gn_stats`` + ``gn_apply`` pair's launch plan at the VAE's pair
maps, a mirror of its chunked statistics against ``gn_stats_plain``, and the
port's statistics against the JAX ``_stats_kernel`` (interpret mode).

``kernels.groupnorm.group_norm_plain`` repeats the cluster kernel's
arithmetic (E[x²] − E[x]² statistics in float32, y = x·A + B, SiLU). The
group widths cover the kernel's three cp.async piece sizes at bf16 (gs = 4:
8-byte rows, gs = 10 and 30: 20- and 60-byte rows in 4-byte pieces) and
16-, 40- and 120-byte rows in float32. Tolerance 1e-5 absolute, as
``tests/test_torch_ops.py``'s GroupNorm tests (the summation order of the
statistics). The kernel itself is held to the plain version on the card by
``chip_smoke.py`` and the ``cuda`` test below.
"""

import numpy as np
import pytest
import torch

import diffusion_uncertainty_tpu.ops.groupnorm as jgn
from diffusion_uncertainty_torch import kernels
from diffusion_uncertainty_torch.kernels import groupnorm as kgn
from diffusion_uncertainty_torch.ops import group_norm_silu
from diffusion_uncertainty_torch.ops.groupnorm import _reference_impl

ATOL = 1e-5
# (C, groups): group widths 4, 10 and 30
WIDTHS = [(128, 32), (320, 32), (960, 32)]
VARIANTS = [(False, False), (False, True), (True, True)]  # (scale-shift, SiLU)


def _inputs(seed, b, h, w, c, ss):
    rng = np.random.RandomState(seed)
    r = lambda *s, scale=1.0, shift=0.0: (rng.randn(*s) * scale + shift).astype(np.float32)  # noqa: E731
    x = r(b, h, w, c, scale=2.0, shift=0.3)
    gamma, beta = r(c, scale=0.2, shift=1.0), r(c, scale=0.2)
    sc = r(b, c, scale=0.3) if ss else None
    sh = r(b, c, scale=0.3) if ss else None
    return x, gamma, beta, sc, sh


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("ss,silu", VARIANTS)
@pytest.mark.parametrize("c,groups", WIDTHS)
def test_plain_matches_jax_pallas_kernel(monkeypatch, c, groups, ss, silu):
    """The plain version against the Pallas ``_kernel`` (one [HW, C] slab per
    image, interpret mode), called through its launcher, since the JAX op
    routes C % 128 != 0 to XLA."""
    import jax.numpy as jnp

    b, h, w = 2, 4, 4
    x, gamma, beta, sc, sh = _inputs(c + 7 * ss + silu, b, h, w, c, ss)
    reached = []
    kernel = jgn._kernel
    monkeypatch.setattr(jgn, "_kernel", lambda *a, **kw: reached.append(1) or kernel(*a, **kw))
    zeros = np.zeros((b, c), np.float32)
    ref = jgn._fused_gn_impl(
        jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(gamma[None]), jnp.asarray(beta[None]),
        jnp.asarray((sc if ss else zeros)[:, None]), jnp.asarray((sh if ss else zeros)[:, None]),
        groups, 1e-5, silu, ss,
    )
    assert reached, "the JAX call did not reach _kernel"
    got = kgn.group_norm_plain(_t(x), _t(gamma), _t(beta), groups, 1e-5, _t(sc), _t(sh), silu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, h, w, c), atol=ATOL, rtol=0)


@pytest.mark.parametrize("ss,silu", VARIANTS)
@pytest.mark.parametrize("c,groups", WIDTHS)
def test_plain_matches_reference_impl(c, groups, ss, silu):
    """The plain version against the op's two-pass reference, and the op on
    a CPU tensor (which runs the reference) against both."""
    x, gamma, beta, sc, sh = _inputs(c + ss, 2, 6, 4, c, ss)
    args = (_t(x), _t(gamma), _t(beta), groups, 1e-6, _t(sc), _t(sh), silu)
    got = kgn.group_norm_plain(*args)
    ref = _reference_impl(*args)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    assert torch.equal(kgn.group_norm(*args), got)  # a CPU tensor takes the plain version
    op = group_norm_silu(_t(x), _t(gamma), _t(beta), groups, 1e-6, _t(sc), _t(sh), silu)
    torch.testing.assert_close(op, got, atol=ATOL, rtol=0)


def test_plain_takes_chunked_scale_shift_and_bf16_parameters():
    """scale and shift as the two halves of one [B, 2C] projection (strided
    views, as ADM's ResBlock passes them), and bf16 γ, β: read as they come."""
    x, gamma, beta, sc, sh = _inputs(5, 2, 4, 4, 64, True)
    emb = torch.from_numpy(np.concatenate([sc, sh], axis=1))
    s_view, t_view = emb.chunk(2, dim=-1)
    assert s_view.stride(0) == 128
    g16, b16 = _t(gamma).to(torch.bfloat16), _t(beta).to(torch.bfloat16)
    got = kgn.group_norm_plain(_t(x), g16, b16, 8, 1e-5, s_view, t_view, True)
    ref = _reference_impl(_t(x), g16, b16, 8, 1e-5, _t(sc).reshape(2, 1, 1, 64), _t(sh).reshape(2, 1, 1, 64), True)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)


# every GroupNorm site (H, W, C, groups) of the ported UNets at their main-path
# batches (chip_smoke.py phase 2's shapes), and the SD VAE decoder's maps
ADM_SITES = [
    (128, 128, 256, 16), (128, 128, 256, 32), (64, 64, 256, 16), (64, 64, 256, 32), (64, 64, 512, 32),
    (64, 64, 768, 32), (32, 32, 256, 32), (32, 32, 512, 16), (32, 32, 512, 32), (32, 32, 768, 32),
    (32, 32, 1280, 32), (16, 16, 512, 32), (16, 16, 768, 16), (16, 16, 768, 32), (16, 16, 1024, 32),
    (16, 16, 1280, 32), (16, 16, 1792, 32), (8, 8, 768, 32), (8, 8, 1024, 16), (8, 8, 1024, 32), (8, 8, 1792, 32),
]
SD_SITES = [
    (64, 64, 320, 32), (64, 64, 640, 32), (64, 64, 960, 32), (32, 32, 320, 32), (32, 32, 640, 32),
    (32, 32, 960, 32), (32, 32, 1280, 32), (32, 32, 1920, 32), (16, 16, 640, 32), (16, 16, 1280, 32),
    (16, 16, 1920, 32), (16, 16, 2560, 32), (8, 8, 1280, 32), (8, 8, 2560, 32),
]
CIFAR_SITES = [
    (32, 32, 128, 32), (32, 32, 256, 32), (32, 32, 384, 32), (16, 16, 128, 32), (16, 16, 256, 32),
    (16, 16, 384, 32), (16, 16, 512, 32), (8, 8, 256, 32), (8, 8, 512, 32), (4, 4, 256, 32), (4, 4, 512, 32),
]
VAE_SITES = [(64, 64, 512, 32), (128, 128, 512, 32), (256, 256, 256, 32), (256, 256, 512, 32), (512, 512, 128, 32),
             (512, 512, 256, 32)]


@pytest.mark.parametrize(
    "model,batches,sites",
    [("adm", (2, 8, 40), ADM_SITES), ("sd", (1, 2, 10), SD_SITES), ("cifar", (128, 640), CIFAR_SITES)],
)
def test_every_unet_site_takes_one_launch(model, batches, sites):
    """bf16 UNets at their batches (ADM 8 and its M=5 members, SD's CFG 2 and
    ensemble 10, CIFAR-10's 128 and the folded 640): one launch, the cluster
    within 8 blocks and the block's rows within the 64 KB budget."""
    for n in batches:
        for h, w, c, g in sites:
            kind, k = kgn.route(n, h * w, c, g, 2)
            assert kind == "one_launch", (model, n, h, w, c, g)
            rows = -(-(h * w) // k)
            assert 1 <= k <= kgn.GN_MAX_CLUSTER and rows * (c // g) * 2 <= kgn.GN_BLOCK_BYTES
            assert (k - 1) * rows < h * w  # every block of the cluster holds rows


def test_cluster_fills_the_card_at_sd_batch_2():
    """N·G = 64 blocks at SD's batch 2: k is raised until the grid covers the
    132 SMs; ADM's largest group needs all 8 blocks by bytes alone."""
    for h, w, c, g in SD_SITES:
        kind, k = kgn.route(2, h * w, c, g, 2)
        assert kind == "one_launch" and 2 * g * k >= kgn.NUM_SMS
    assert kgn.route(8, 128 * 128, 256, 16, 2) == ("one_launch", 8)  # 512 KB in 8 blocks of 64 KB
    assert kgn.route(128, 32 * 32, 128, 32, 2) == ("one_launch", 1)  # 4096 blocks fill the card alone


def test_vae_large_maps_take_the_pair():
    """The float32 VAE: 64x64 maps (256 KB groups) in one launch; 128x128 (1
    MB: 16 blocks of 64 KB), 256x256 and 512x512 beyond 8 blocks: the pair."""
    for h, w, c, g in VAE_SITES:
        kind, k = kgn.route(1, h * w, c, g, 4)
        assert kind == ("one_launch" if h == 64 else "pair"), (h, w, c, g)
    # 4 blocks hold the 256 KB group; 32 groups x 5 blocks cover the 132 SMs
    assert kgn.route(1, 64 * 64, 512, 32, 4) == ("one_launch", 5)


def test_route_rejects_what_the_kernel_cannot_take():
    assert kgn.route(2, 64, 32, 32, 2)[0] == "pair"  # 2-byte rows: no cp.async piece
    assert kgn.route(2, 64, 128, 32, 2, ptr=2)[0] == "pair"  # x not on 4 bytes
    assert kgn.route(2, 64, 4096, 4, 4)[0] == "pair"  # a group of 1024 channels: wider than the tables
    assert kgn.piece_bytes(20, 0) == 4 and kgn.piece_bytes(40, 0) == 8 and kgn.piece_bytes(80, 16) == 16


def test_route_counters():
    kernels.reset_launch_counts()
    kgn.ROUTE_LAUNCHES["one_launch"] += 2
    kgn.ROUTE_LAUNCHES["pair"] += 1
    assert kernels.gn_route_counts() == {"one_launch": 2, "pair": 1}
    assert "group_norm" in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.gn_route_counts() == {"one_launch": 0, "pair": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_on_card(cuda, dtype):
    """The one-launch kernel against its plain version at group widths 4, 10,
    30 (4-, 8- and 16-byte pieces), with and without scale-shift and SiLU,
    chunked scale-shift views, a cluster of 8 with ragged rows, a map smaller
    than the cluster the card-filling rule asks for, and the pair for a group
    beyond 8 blocks."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)  # noqa: E731
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    cases = [(2, 8, 8, c, groups, ss, silu) for c, groups in WIDTHS for ss, silu in VARIANTS]
    cases += [(1, 37, 29, 320, 32, True, True), (2, 2, 2, 640, 32, False, True), (3, 5, 7, 96, 6, True, False)]
    def close(y, want):
        bound = tol + (2.0**-7 * want.abs() if dtype == torch.bfloat16 else 0.0)
        return bool(((y.float() - want).abs() <= bound).all())

    for n, h, w, c, groups, ss, silu in cases:
        x = r(n, h, w, c)
        emb = r(n, 2 * c) * 0.1
        sc, sh = emb.chunk(2, dim=-1) if ss else (None, None)
        args = (x, r(c) * 0.1 + 1.0, r(c) * 0.1, groups, 1e-6, sc, sh, silu)
        kernels.reset_launch_counts()
        y = kgn.group_norm(*args)
        assert kernels.gn_route_counts()["one_launch"] == 1 and kernels.launch_counts()["group_norm"] == 1
        assert close(y, kgn.group_norm_plain(*args).float()), (n, h, w, c, groups, ss, silu)
    args = (r(1, 256, 256, 64), r(64), r(64), 2, 1e-6)  # 2 MB groups: beyond 8 blocks
    kernels.reset_launch_counts()
    y = kgn.group_norm(*args)
    assert kernels.gn_route_counts() == {"one_launch": 0, "pair": 1} and kernels.launch_counts()["group_norm"] == 0
    assert close(y, kgn.group_norm_plain(*args).float())


# ---- the gn_stats + gn_apply pair ----------------------------------------

VAE_PAIR_SITES = [s for s in VAE_SITES if kgn.route(1, s[0] * s[1], s[2], s[3], 4)[0] == "pair"]


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("h,w,c,g", VAE_PAIR_SITES)
def test_pair_plan_is_wide_and_fills_the_card_at_vae_sites(h, w, c, g, elem_size):
    """float32 and bf16 at batch 1: both kernels on 16-byte words, every SM
    given its share of blocks (one gn_stats block, 32 gn_apply blocks, fewer
    only where the map has fewer block steps of rows), each block's threads
    on whole rows, every block with rows, 32-bit offsets."""
    for kernel, (threads, per_sm) in kgn.PAIR_GRID.items():
        p = kgn.plan(kernel, 1, h * w, c, elem_size, 0)
        assert p.route == "wide" and p.vec == 16 // elem_size and p.idx32 and p.threads == threads
        assert p.blocks == p.chunks == min(per_sm * kgn.NUM_SMS, h * w // p.phases) >= kgn.NUM_SMS
        assert p.tile_w == c // p.vec and p.tile_w * p.phases == threads
        assert p.chunks * p.phases <= h * w


@pytest.mark.parametrize("kernel", sorted(kgn.PAIR_GRID))
@pytest.mark.parametrize("elem_size", [4, 2])
def test_pair_plan_takes_the_scalar_route_exactly_where_16_bytes_do_not_divide(kernel, elem_size):
    """The scalar route where a row's bytes or a pointer are not a multiple
    of 16, the wide route everywhere else; rows wider than a block split
    into column tiles; a block for every image at large batches and no block
    without rows on small maps; 64-bit offsets past 2^31."""
    threads = kgn.PAIR_GRID[kernel][0]
    for c in (4, 6, 8, 12, 30, 64, 96, 100, 128, 320, 4096):
        for ptr in (0, 2, 4, 8, 16, 48):
            p = kgn.plan(kernel, 2, 64, c, elem_size, ptr)
            wide = (c * elem_size) % 16 == 0 and ptr % 16 == 0
            assert p.route == ("wide" if wide else "scalar"), (c, ptr)
            assert p.tile_w == min(c // p.vec, threads) and p.phases == threads // p.tile_w
            assert 1 <= p.chunks and (p.chunks - 1) * p.phases < 64
    assert kgn.plan(kernel, 10**4, 64, 128, elem_size).chunks == 1
    assert not kgn.plan(kernel, 1, 2**22, 1024, elem_size).idx32
    with pytest.raises(ValueError):
        kgn.plan(kernel, 1, 64, kgn.PAIR_MAX_C + 8, elem_size)


def _stats_mirror(x, gamma, beta, groups, eps, scale, shift):
    """gn_stats's partition in torch ops: the per-channel sums of each block
    of ``plan`` (rows k·phases + p + j·chunks·phases: each row phase apart,
    then the phases in order), the block's group partials, their sum over
    blocks in the last block's fixed order (a chunk phase per thread, then
    the phases in order), E[x²] − E[x]² in float32 and the A, B fold."""
    n, h, w, c = x.shape
    p = kgn.plan("gn_stats", n, h * w, c, x.element_size(), 0)
    gs = c // groups
    xf = x.float().reshape(n, h * w, c)
    step = p.chunks * p.phases
    parts = []
    for k in range(p.chunks):
        s1 = sum(xf[:, k * p.phases + ph::step].sum(1) for ph in range(p.phases))  # [n, c]
        s2 = sum((xf[:, k * p.phases + ph::step] ** 2).sum(1) for ph in range(p.phases))
        parts.append(torch.stack([s1.reshape(n, groups, gs).sum(-1), s2.reshape(n, groups, gs).sum(-1)], -1))
    part = torch.stack(parts, 1)  # [n, chunks, G, 2], the workspace
    fold_p = max(kgn.STATS_THREADS // (2 * groups), 1)
    tot = sum(part[:, q::fold_p].sum(1) for q in range(fold_p))  # [n, G, 2]
    cnt = float(h * w * gs)
    mean, ex2 = tot[..., 0] / cnt, tot[..., 1] / cnt
    inv = torch.rsqrt(ex2 - mean * mean + eps)
    a = (inv[:, :, None] * gamma.float().reshape(groups, gs)).reshape(n, c)
    b = beta.float() - mean.repeat_interleave(gs, 1) * a
    if scale is not None:
        a, b = a * (1 + scale.float()), b * (1 + scale.float()) + shift.float()
    return a, b


@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("c,groups", [(128, 32), (256, 32)])
def test_pair_statistics_mirror_matches_plain(c, groups, ss):
    """The VAE's 4- and 8-channel groups over 2 images of 2500 rows (66
    blocks an image, each of several row steps): the partitioned statistics
    equal gn_stats_plain within 1e-6 relative."""
    x, gamma, beta, sc, sh = _inputs(c + ss, 2, 50, 50, c, ss)
    args = (_t(x), _t(gamma), _t(beta), groups, 1e-6, _t(sc), _t(sh))
    p = kgn.plan("gn_stats", 2, 2500, c, 4, 0)
    assert p.chunks == kgn.NUM_SMS // 2 and 2500 // (p.chunks * p.phases) >= 2
    for got, want in zip(_stats_mirror(*args), kgn.gn_stats_plain(*args)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    for got, want in zip(kgn.gn_stats(*args), kgn.gn_stats_plain(*args)):  # a CPU tensor takes the plain version
        assert torch.equal(got, want)


@pytest.mark.parametrize("ss", [False, True])
def test_pair_statistics_match_jax_stats_kernel(monkeypatch, ss):
    """The JAX ``_stats_kernel`` route (Pallas interpret mode, [HW, N, C]
    view, ``DU_TPU_GN_XLA_STATS=0``) at 4 channels per group: its per-(n, c)
    A, B against gn_stats's plain version and the partition mirror, and the
    op's output against gn_apply's plain version, float32."""
    import jax.numpy as jnp

    monkeypatch.setenv("DU_TPU_GN_XLA_STATS", "0")
    b, h, w, c, groups = 8, 32, 32, 128, 32
    x, gamma, beta, sc, sh = _inputs(11 + ss, b, h, w, c, ss)
    coef = []
    stats = jgn._gn_stats_hwnc
    monkeypatch.setattr(jgn, "_gn_stats_hwnc", lambda *a, **kw: coef.append(stats(*a, **kw)) or coef[-1])
    kernel = jgn._stats_kernel
    reached = []
    monkeypatch.setattr(jgn, "_stats_kernel", lambda *a, **kw: reached.append(1) or kernel(*a, **kw))
    ref = jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), num_groups=groups,
                              scale=None if sc is None else jnp.asarray(sc), shift=None if sh is None else jnp.asarray(sh),
                              use_pallas=True)
    assert coef and reached, "the JAX call did not reach _stats_kernel"
    args = (_t(x), _t(gamma), _t(beta), groups, 1e-5, _t(sc), _t(sh))
    ja, jb = (torch.from_numpy(np.array(t)) for t in coef[0])
    for ours in (kgn.gn_stats_plain(*args), _stats_mirror(*args)):
        torch.testing.assert_close(ours[0], ja, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ours[1], jb, rtol=1e-5, atol=1e-5)
    y = kgn.gn_apply_plain(_t(x), *kgn.gn_stats_plain(*args), True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_pair_route_counters():
    kernels.reset_launch_counts()
    kgn.PAIR_ROUTE_LAUNCHES["wide"] += 3
    assert kernels.gn_pair_route_counts() == {"wide": 3, "scalar": 0}
    kernels.reset_launch_counts()
    assert kernels.gn_pair_route_counts() == {"wide": 0, "scalar": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernels_on_card(cuda, dtype):
    """gn_stats and gn_apply against their plain versions at the VAE's pair
    maps (batch 1, SiLU) and at shapes off the wide route or with several
    images, scale-shift and column tiles; two gn_stats calls bit-identical;
    one launch of each, counted by the plan's route."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)  # noqa: E731
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    cases = [(1, h, w, c, groups, False, True) for h, w, c, groups in VAE_PAIR_SITES]
    cases += [(3, 9, 7, 96, 6, True, False), (2, 33, 17, 12, 3, True, True), (2, 5, 3, 4096, 4, True, True)]
    for n, h, w, c, groups, ss, silu in cases:
        x = r(n, h, w, c)
        sc, sh = (r(n, c) * 0.1, r(n, c) * 0.1) if ss else (None, None)
        args = (x, r(c) * 0.1 + 1.0, r(c) * 0.1, groups, 1e-6, sc, sh)
        kernels.reset_launch_counts()
        a, b = kgn.gn_stats(*args)
        y = kgn.gn_apply(x, a, b, silu)
        route = kgn.plan("gn_stats", n, h * w, c, x.element_size(), x.data_ptr() % 16).route
        assert kernels.launch_counts()["gn_stats"] == kernels.launch_counts()["gn_apply"] == 1
        assert kernels.gn_pair_route_counts()[route] == 2
        a2, b2 = kgn.gn_stats(*args)
        assert torch.equal(a, a2) and torch.equal(b, b2), (n, h, w, c, groups)
        ap, bp = kgn.gn_stats_plain(*args)
        assert float((a - ap).abs().max()) <= 1e-3 and float((b - bp).abs().max()) <= 1e-3, (n, h, w, c, groups)
        want = kgn.gn_apply_plain(x, a, b, silu).float()
        bound = tol + (2.0**-7 * want.abs() if dtype == torch.bfloat16 else 0.0)
        assert bool(((y.float() - want).abs() <= bound).all()), (n, h, w, c, groups, ss, silu)
