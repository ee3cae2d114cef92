"""The port's 2×2 avg-pool and phase-interleave / nearest-upsample ops, single
and paired, against the JAX package, float32 on the CPU.

The port's ops run their plain versions here (the tensors lie on the CPU);
the JAX ops run their XLA route (``use_pallas=False``) and their Pallas route
in interpret mode. Tolerances: the interleave and the upsample are copies,
bit-exact; pools and gradients that add values at 1e-6 (float32 rounding of
a sum of four). The route plans are pure Python and are checked at
every ADM-128, SD 1.5 and CIFAR-10 site; the kernels themselves run only on
the card (the ``cuda`` test, and ``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_uncertainty_torch.models.adm_unet as tadm
from diffusion_uncertainty_torch.kernels import avgpool as kpool
from diffusion_uncertainty_torch.kernels import interleave as kilv
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.ops import (
    avg_pool_2x2,
    avg_pool_2x2_pair,
    interleave_and_upsample_2x,
    interleave_phases_2x,
    nearest_upsample_2x,
)
from diffusion_uncertainty_torch.scripts.bench_resample import sites
from diffusion_uncertainty_tpu.ops import fused_upsample as jfu
from diffusion_uncertainty_tpu.ops.avgpool import avg_pool_2x2 as j_avg_pool

ATOL = 1e-6
# the Pallas routes of the JAX ops take N % 8 == 0 and C % 128 == 0
SHAPE = (8, 6, 4, 128)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _grads(fn, ins, cts):
    """Port gradients of fn's outputs (a tensor or a tuple) for cotangents cts."""
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    outs = fn(*tins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [g.numpy() for g in torch.autograd.grad(outs, tins, [torch.from_numpy(c) for c in cts])]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_avg_pool_gradient_matches_jax_vjp(use_pallas):
    """The repaired op: ``_AvgPool`` records a graph and its backward is
    ``_avgpool_with_xla_grad``'s (Pallas route) / XLA's (jnp route)."""
    rng = np.random.RandomState(0)
    x, ct = _rand(rng, *SHAPE), _rand(rng, SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, SHAPE[3])
    out, vjp = jax.vjp(lambda a: j_avg_pool(a, use_pallas=use_pallas), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_()
    got = avg_pool_2x2(tx)
    assert type(got.grad_fn).__name__ == "_AvgPoolBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL, rtol=0)
    (g,) = torch.autograd.grad(got, tx, torch.from_numpy(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paired_plain_forms_match_two_single_jax_calls(use_pallas):
    rng = np.random.RandomState(1)
    a, b = _rand(rng, *SHAPE), _rand(rng, *SHAPE)
    pa, pb = avg_pool_2x2_pair(torch.from_numpy(a), torch.from_numpy(b))
    for got, ref in ((pa, a), (pb, b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_avg_pool(jnp.asarray(ref), use_pallas=use_pallas)),
                                   atol=ATOL, rtol=0)
    ys, x = [_rand(rng, 8, 3, 4, 128) for _ in range(4)], _rand(rng, 8, 3, 4, 128)
    h, up = interleave_and_upsample_2x([torch.from_numpy(y) for y in ys], torch.from_numpy(x))
    # the Pallas route takes the nearest upsample through `_ilv_kernel` too
    np.testing.assert_array_equal(h.numpy(), np.asarray(jfu.interleave_phases_2x(*map(jnp.asarray, ys), use_pallas=use_pallas)))
    np.testing.assert_array_equal(up.numpy(), np.asarray(jfu.nearest_upsample_2x(jnp.asarray(x), use_pallas=use_pallas)))
    np.testing.assert_array_equal(nearest_upsample_2x(torch.from_numpy(x)).numpy(), up.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paired_backwards_match_jax_vjp(use_pallas):
    rng = np.random.RandomState(2)
    a, b = _rand(rng, *SHAPE), _rand(rng, *SHAPE)
    cts = [_rand(rng, SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, SHAPE[3]) for _ in range(2)]
    _, vjp = jax.vjp(lambda u, v: (j_avg_pool(u, use_pallas=use_pallas), j_avg_pool(v, use_pallas=use_pallas)),
                     jnp.asarray(a), jnp.asarray(b))
    for got, want in zip(_grads(avg_pool_2x2_pair, [a, b], cts), vjp(tuple(map(jnp.asarray, cts)))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)

    ins = [_rand(rng, 8, 3, 4, 128) for _ in range(5)]
    cts = [_rand(rng, 8, 6, 8, 128) for _ in range(2)]

    def jfn(*t):
        return (jfu.interleave_phases_2x(*t[:4], use_pallas=use_pallas), jfu.nearest_upsample_2x(t[4], use_pallas=use_pallas))

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    want = [np.asarray(w) for w in vjp(tuple(map(jnp.asarray, cts)))]
    got = _grads(lambda *t: interleave_and_upsample_2x(t[:4], t[4]), ins, cts)
    for g, w in zip(got[:4], want[:4]):  # the interleave's gradient is the cotangent's phases
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[4], want[4], atol=ATOL, rtol=0)  # the upsample's: their sum
    (g_near,) = _grads(nearest_upsample_2x, ins[4:], cts[1:])
    np.testing.assert_allclose(g_near, want[4], atol=ATOL, rtol=0)


@pytest.mark.parametrize("model", ["adm", "sd", "cifar"])
def test_plans_take_the_bulk_route_at_every_site(model):
    """bf16 at the main-path batches, aligned pointers: every pool and
    interleave site takes the widest route (16-byte words), single and
    paired. (The name dates from a staged route that was measured and
    dropped; the check is the plan's at every model site.)"""
    by_kind = sites()[model]
    assert by_kind["interleave"] and (model != "adm" or len(by_kind["pool"]) == 4)
    for n, h, w, c in by_kind["interleave"]:
        pb = 2 * c
        for jobs in (((pb, 16),), ((pb, 16), (pb, 16))):
            assert kilv.plan(jobs) == ("wide", 16), (model, jobs)
    for n, h, w, c in by_kind["pool"]:
        assert kpool.plan(2 * c, 16) == "wide", (model, (n, h, w, c))


def test_plans_route_what_the_bulk_route_cannot_take():
    """Pixels not a multiple of 16 bytes, or pointers on 8 or 4 bytes, take
    the narrow route. (The name dates from the dropped staged route.)"""
    assert kilv.plan(((24, 16),)) == ("narrow", 4)
    assert kilv.plan(((256, 8),)) == ("narrow", 4)
    assert kilv.plan(((8192, 16),)) == ("wide", 16)
    # a pair takes the word both jobs take
    assert kilv.plan(((256, 16), (6, 16))) == ("narrow", 2)
    with pytest.raises(ValueError):
        kilv.plan(((3, 16),))
    assert kpool.plan(24, 16) == "narrow"
    assert kpool.plan(256, 8) == "narrow"
    assert kpool.plan(512, 16) == "wide"
    assert kpool.plan(8192, 16) == "wide"


def _tiny_configs(channel_mult):
    from diffusion_uncertainty_tpu.models import ADMUNetConfig  # flax: not on the card's machine, see the cuda test

    j = dataclasses.replace(ADMUNetConfig.tiny(), channel_mult=channel_mult)
    t = dataclasses.replace(TADMUNetConfig.tiny(), channel_mult=channel_mult)
    assert j.resblock_updown and t.resblock_updown
    return j, t


def _unpaired(monkeypatch):
    """The ADM up/down ResBlocks with one op call per tensor, as before the pairs."""
    monkeypatch.setattr(tadm, "avg_pool_2x2_pair", lambda h, x: (avg_pool_2x2(h), avg_pool_2x2(x)))
    monkeypatch.setattr(tadm, "interleave_and_upsample_2x", lambda ph, x: (interleave_phases_2x(*ph), nearest_upsample_2x(x)))


@pytest.mark.parametrize("channel_mult", [(1, 2), (1, 2, 2)])
def test_tiny_adm_updown_matches_jax_and_the_unpaired_form(monkeypatch, channel_mult):
    from test_torch_helpers import make_adm_state_dict, torch_state_dict

    from diffusion_uncertainty_tpu.models import ADMUNet
    from diffusion_uncertainty_tpu.models.convert import convert_adm_unet

    jcfg, tcfg = _tiny_configs(channel_mult)
    sd = make_adm_state_dict(jcfg, seed=4)
    model = TADMUNet(tcfg)
    model.load_state_dict(torch_state_dict(sd))
    model.eval()
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    y = np.array([1, 7])
    ref = ADMUNet(jcfg).apply(convert_adm_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(321), jnp.asarray(y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 321, torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    _unpaired(monkeypatch)
    with torch.no_grad():
        unpaired = model(torch.from_numpy(x), 321, torch.from_numpy(y))
    torch.testing.assert_close(out, unpaired, atol=0, rtol=0)


@pytest.mark.parametrize("channel_mult", [(1, 2), (1, 2, 2)])
def test_tiny_adm_makes_one_resample_call_per_updown_resblock(monkeypatch, channel_mult):
    _, tcfg = _tiny_configs(channel_mult)
    calls = {name: 0 for name in ("avg_pool_2x2", "avg_pool_2x2_pair", "interleave_2x", "nearest_2x", "interleave_2x_pair")}

    def counting(mod, name):
        fn = getattr(mod, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)

        monkeypatch.setattr(mod, name, call)

    for name in calls:
        counting(kpool if "pool" in name else kilv, name)
    model = TADMUNet(tcfg).eval()
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(6))
    for grad in (False, True):
        for k in calls:
            calls[k] = 0
        with torch.set_grad_enabled(grad):
            model(x.requires_grad_(grad), 321, torch.tensor([1, 7]))
        n_down = sum(isinstance(m, tadm.ResBlock) and m.down for m in model.modules())
        n_up = sum(isinstance(m, tadm.ResBlock) and m.up for m in model.modules())
        assert n_down == n_up == len(channel_mult) - 1
        assert calls == {"avg_pool_2x2": 0, "avg_pool_2x2_pair": n_down, "interleave_2x": 0, "nearest_2x": 0,
                         "interleave_2x_pair": n_up}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resample_kernels_on_card(cuda, dtype):
    """Both kernels against their plain versions, single and paired, at
    ragged row and column counts, on both routes; the gradient through the
    CUDA ops against the plain versions'. (The machine with the card has JAX
    but not flax: this file imports the JAX models inside the tests that
    need them, so that it collects there.)"""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s, off=0):
        n = int(np.prod(s))
        return torch.randn(n + off, generator=g, device=cuda).to(dtype)[off:].view(*s)

    for shape in ((3, 5, 7, 128), (2, 3, 40, 64), (8, 16, 16, 768), (2, 3, 5, 24)):
        for off in (0, 2):  # 2 elements: pointers off 16 bytes, the narrow route
            ys, x = [r(*shape, off=off) for _ in range(4)], r(*shape)
            kilv.ROUTE_LAUNCHES.clear()
            assert torch.equal(kilv.interleave_2x(*ys), kilv.interleave_2x_plain(*ys))
            assert torch.equal(kilv.nearest_2x(x), kilv.nearest_2x_plain(x))
            h, up = kilv.interleave_2x_pair(ys, x)
            assert torch.equal(h, kilv.interleave_2x_plain(*ys)) and torch.equal(up, kilv.nearest_2x_plain(x))
            wide = off == 0 and shape[-1] * ys[0].element_size() % 16 == 0
            assert kilv.ROUTE_LAUNCHES["wide" if wide else "narrow"] >= 2 and kilv.ROUTE_LAUNCHES["pair"] == 1
    for shape in ((3, 6, 10, 128), (2, 4, 600, 64), (8, 16, 16, 768), (2, 4, 6, 12)):
        for off in (0, 2):
            a, b = r(*shape, off=off), r(*shape)
            kpool.ROUTE_LAUNCHES.clear()
            for got, want in ((kpool.avg_pool_2x2(a), kpool.avg_pool_2x2_plain(a)),
                              *zip(kpool.avg_pool_2x2_pair(a, b), kpool.avg_pool_2x2_pair_plain(a, b))):
                assert torch.equal(got, want)  # the plain version's arithmetic, in its order
            assert kpool.ROUTE_LAUNCHES["pair"] == 1
    a, b = (r(2, 8, 8, 128).float().requires_grad_(True) for _ in range(2))
    ct = torch.randn(2, 4, 4, 128, generator=g, device=cuda)
    got = torch.autograd.grad([(p * ct).sum() for p in avg_pool_2x2_pair(a, b)], (a, b))
    want = torch.autograd.grad([(p * ct).sum() for p in kpool.avg_pool_2x2_pair_plain(a, b)], (a, b))
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, atol=0, rtol=0)
