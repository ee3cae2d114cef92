"""The port's attention at SD 1.5's head dims and the VAE's wide head against
the JAX package, float32 on the CPU, and the host-side arithmetic of the
kernel routes (route choice, the key split and its combine).

The port runs its plain versions here (the tensors lie on the CPU); the JAX
side runs its XLA route (``use_pallas=False``) and its Pallas kernels in
interpret mode: the packed-head ``_kernel`` (``use_pallas=True``) and the
long-key flash ``_kernel`` (``_flash_attention(whole_row=False)``, key blocks
of 64 so the online softmax takes two or more steps). Tolerance: max abs
``ATTN_ATOL`` = 2e-5, as in ``tests/test_torch_ops.py``, for the summation
order of the logits and of P·V.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_uncertainty_torch.kernels import _build
from diffusion_uncertainty_torch.kernels import attention as katt
from diffusion_uncertainty_torch.ops import dot_product_attention
from diffusion_uncertainty_tpu.ops.attention import dot_product_attention as j_attention
from diffusion_uncertainty_tpu.ops.flash_attention import _flash_attention

ATTN_ATOL = 2e-5


def _qkv(seed, b, s, s_kv, h, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, n, h, d).astype(np.float32) for n in (s, s_kv, s_kv))


def _jax_refs(q, k, v, kv_len):
    """(XLA route on the real keys, packed-head Pallas kernel on the real
    keys, long-key flash Pallas kernel on the padded keys with kv_len)."""
    n = k.shape[1] if kv_len is None else kv_len
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    return (
        np.asarray(j_attention(jq, jk[:, :n], jv[:, :n], use_pallas=False)),
        np.asarray(j_attention(jq, jk[:, :n], jv[:, :n], use_pallas=True)),
        np.asarray(_flash_attention(jq, jk, jv, bq=64, bk=64, whole_row=False, kv_len=kv_len)),
    )


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("kv_len", [None, 77], ids=["self", "cross77"])
def test_sd_head_dims_match_jax(d, kv_len):
    """SD 1.5's head dims: self-attention, and 77-key cross-attention with the
    keys padded to 128 and masked by kv_len."""
    q, k, v = _qkv(d, 1, 128, 128, 2, d)
    out = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=kv_len).numpy()
    for ref in _jax_refs(q, k, v, kv_len):
        np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("kv_len", [None, 77])
def test_wide_head_matches_jax(kv_len):
    """The VAE's single-head D=512 attention."""
    q, k, v = _qkv(512, 1, 128, 128, 1, 512)
    out = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=kv_len).numpy()
    for ref in _jax_refs(q, k, v, kv_len):
        np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("n_splits", [1, 2, 3])
@pytest.mark.parametrize("kv_len", [None, 77])
def test_split_plain_matches_plain_and_jax(n_splits, kv_len):
    """The wide route's key split and combine: 128 keys, or 77 of them, cut
    into whole 16-key tiles; with kv_len=77 the last split ends inside a
    tile, whose keys past 77 get zero weight."""
    q, k, v = _qkv(7, 2, 64, 128, 1, 512)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    n_keys = 128 if kv_len is None else kv_len
    chunk, used = katt.split_chunk(n_keys, n_splits)
    assert used == n_splits and chunk % katt.WIDE_KEY_TILE == 0
    assert (used - 1) * chunk < n_keys <= used * chunk
    out = katt.attention_split_plain(tq, tk, tv, kv_len, n_splits).numpy()
    np.testing.assert_allclose(out, katt.attention_plain(tq, tk, tv, kv_len).numpy(), atol=ATTN_ATOL, rtol=0)
    for ref in _jax_refs(q, k, v, kv_len):
        np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)


def test_split_plain_rounds_p_to_the_value_type():
    """bf16: P is rounded before P·V in every split, as the kernels round it;
    the result stays within bf16 rounding of the float32 function."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(3, 1, 32, 96, 1, 512))
    ref = katt.attention_plain(q.float(), k.float(), v.float())
    for n in (1, 2, 3):
        out = katt.attention_split_plain(q, k, v, None, n)
        assert out.dtype == torch.bfloat16
        assert float((out.float() - ref).abs().max()) <= 2.0**-6 * float(ref.abs().max())


def test_route_policy():
    bf16, f32 = torch.bfloat16, torch.float32
    for d in (40, 80, 160, 64, 128, 192, 256, 72):  # SD 1.5, ADM-128, CIFAR-10, U-ViT
        assert katt.route(bf16, d, True) == "tensor_core"
        assert katt.route(bf16, d, False) == "cuda_core"
        assert katt.route(f32, d, True) == "cuda_core"
    assert katt.route(bf16, 48, True) == "cuda_core"  # no tensor-core instance
    for dtype in (bf16, f32):
        assert katt.route(dtype, 512, True) == "wide"
        assert katt.route(dtype, 264, True) == "wide"
        with pytest.raises(ValueError, match="16-byte"):
            katt.route(dtype, 512, False)


def test_wide_splits_fill_the_card():
    # the VAE: 64 query tiles; two splits make 128 blocks, one wave on 132 SMs
    assert katt.wide_splits(1, 4096, 1, 4096) == 2
    assert katt.split_chunk(4096, 2) == (2048, 2)
    assert katt.wide_splits(1, 64, 2, 64) == 4  # 2 blocks: as many splits as there are key tiles
    assert katt.wide_splits(64, 4096, 1, 4096) == 1  # 4096 blocks already fill the card
    for n_keys in (1, 15, 16, 17, 77, 300, 4096):
        for n in range(1, katt.MAX_SPLITS + 1):
            chunk, used = katt.split_chunk(n_keys, n)
            assert chunk % katt.WIDE_KEY_TILE == 0 and 1 <= used <= n
            assert (used - 1) * chunk < n_keys <= used * chunk


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 16, 1, 512))
    katt.ROUTE_LAUNCHES.clear()
    torch.testing.assert_close(katt.attention(q, k, v), katt.attention_plain(q, k, v), rtol=0, atol=0)
    assert not any(katt.ROUTE_LAUNCHES.values())


def test_ptxas_report_names_each_instance(monkeypatch):
    """The registers and spills ``chip_smoke.py`` prints for each attention
    kernel instance, parsed from an nvcc -Xptxas -v log."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__49729f7d_12_attention_cu_2ceaeb4819"
        "attention_tc_kernelILi40ELi8EEEvPK13__nv_bfloat16S3_S3_PS1_iiixxxxxxxxxf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__49729f7d_12_attention_cu_2ceaeb4819attention_tc",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 113 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__49729f7d_12_attention_cu_2ceaeb4821"
        "attention_wide_kernelI13__nv_bfloat16EEvPKT_S4_S4_PS2_PfS6_iiiiiiixxxxxxxxxf' for 'sm_90a'",
        "    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 190 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__49729f7d_12_attention_cu_2ceaeb4816"
        "attention_kernelIfLi16EEEvPKT_S3_S3_PS1_iiiiixxxxxxxxxf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    monkeypatch.setitem(_build.build_logs, "attention", log)
    assert _build.ptxas_report("attention") == [
        "attention_tc_kernel<40,8>: 113 registers, 0 bytes spill stores, 0 bytes spill loads",
        "attention_wide_kernel<bf16>: 190 registers, 24 bytes spill stores, 16 bytes spill loads",
        "attention_kernel<float,16>: 128 registers, 0 bytes spill stores, 0 bytes spill loads",
    ]
