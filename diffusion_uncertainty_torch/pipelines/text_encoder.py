"""Text conditioning of the text-to-image pipelines: the SD 1.x CLIP
encoding, SD3 / Flux's CLIP-L + CLIP-bigG + T5-XXL towers, and the
hash-seeded stand-ins used where no tokenizer or weights are on disk.

JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/text_encoder.py``
(``pseudo_text_embeddings``, ``encode_tokens_flax``, ``encode_prompts``,
``encode_prompts_ex``, ``pseudo_token_ids``, ``_clip_tokenize``,
``_t5_tokenize``, ``T2ITowers``, :38-363). The numpy stand-ins are copies
with the same bits. Tokenization tries ``transformers`` with local files only
and falls back to pseudo token ids on the same construction-time errors as
JAX (a missing package, vocabulary or weights); an error while encoding
raises. The towers are the port's own modules (``models.clip_text``,
``models.t5_text``), float32, on the card unless asked for the CPU; their
attention is plain float32 PyTorch, as the JAX towers' einsums are.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..factory import init_normal_
from ..models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ..models.convert import clip_text_state_dict_from_flax, t5_state_dict_from_flax
from ..models.t5_text import T5Config, T5Encoder, init_t5_
from ..utils.device import resolve_device

__all__ = [
    "encode_prompts", "encode_prompts_ex", "encode_tokens", "pseudo_text_embeddings", "pseudo_token_ids", "T2ITowers",
    "CLIP_VOCAB", "CLIP_EOS", "T5_VOCAB", "SD15_TEXT_DIM", "SD15_TEXT_LEN",
]

SD15_TEXT_DIM = 768  # CLIP ViT-L/14 hidden size
SD15_TEXT_LEN = 77
CLIP_VOCAB = 49408
CLIP_EOS = 49407
T5_VOCAB = 32128


def pseudo_text_embeddings(
    prompts: Sequence[str], seq_len: int = SD15_TEXT_LEN, dim: int = SD15_TEXT_DIM
) -> np.ndarray:
    """[len(prompts), seq_len, dim] float32 unit Gaussians seeded by a stable
    hash of each prompt: identical prompts get identical conditioning."""
    out = np.empty((len(prompts), seq_len, dim), np.float32)
    for i, p in enumerate(prompts):
        seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
        out[i] = np.random.RandomState(seed).randn(seq_len, dim).astype(np.float32)
    return out


def pseudo_token_ids(
    prompts: Sequence[str], seq_len: int, vocab_size: int, bos: Optional[int] = None, eos: Optional[int] = None,
    pad: int = 0,
) -> np.ndarray:
    """[len(prompts), seq_len] int32 hash-seeded token ids (the stand-in
    tokenizer): about one id a word plus two, padded, with optional BOS / EOS."""
    out = np.full((len(prompts), seq_len), pad, np.int32)
    for i, p in enumerate(prompts):
        seed = int.from_bytes(hashlib.sha256(("tok:" + p).encode()).digest()[:4], "little")
        rs = np.random.RandomState(seed)
        n = min(max(len(p.split()), 1) + 2, seq_len)
        ids = rs.randint(1, vocab_size - 2, size=n)
        if bos is not None:
            ids[0] = bos
        if eos is not None:
            ids[n - 1] = eos
        out[i, :n] = ids
    return out


@functools.lru_cache(maxsize=8)
def _tokenizer(cls_name: str, src: str):
    """A transformers tokenizer from local files only (never a download),
    built once per process: a CLI run encodes its two prompts with one."""
    import transformers

    return getattr(transformers, cls_name).from_pretrained(src, local_files_only=True)


def _clip_tokenize(prompts, seq_len: int, local_path=None) -> Tuple[np.ndarray, bool]:
    """(ids [B, seq_len] int32, used_pseudo)."""
    try:
        tok = _tokenizer("CLIPTokenizer", local_path or "openai/clip-vit-large-patch14")
    except (ImportError, OSError, TypeError):  # no package or no vocabulary files; TypeError: a cached repo without them
        return pseudo_token_ids(prompts, seq_len, CLIP_VOCAB, bos=CLIP_VOCAB - 2, eos=CLIP_EOS), True
    enc = tok(list(prompts), padding="max_length", max_length=seq_len, truncation=True, return_tensors="np")
    return enc["input_ids"].astype(np.int32), False


def _t5_tokenize(prompts, seq_len: int, local_path=None) -> Tuple[np.ndarray, bool]:
    try:
        tok = _tokenizer("T5TokenizerFast", local_path or "google/t5-v1_1-xxl")
    except (ImportError, OSError, TypeError, ValueError, AttributeError):  # as JAX: transformers' symptoms of missing files
        return pseudo_token_ids(prompts, seq_len, T5_VOCAB, eos=1), True
    enc = tok(list(prompts), padding="max_length", max_length=seq_len, truncation=True, return_tensors="np")
    return enc["input_ids"].astype(np.int32), False


def _tower(make, device) -> torch.nn.Module:
    """``make()`` built on the meta device, then allocated on ``device``
    (float32, eval, no autograd); its weights are left to the caller."""
    with torch.device("meta"):
        module = make()
    return module.to_empty(device=device).eval().requires_grad_(False)


def encode_tokens(state_dict, input_ids: np.ndarray, cfg: Optional[CLIPTextConfig] = None, device="cuda") -> np.ndarray:
    """CLIP text encoding of token ids: [B, L] -> last hidden [B, L, D]
    float32 (numpy), with a transformers-layout state dict, on ``device``
    (JAX ``encode_tokens_flax``)."""
    dev = resolve_device(device)
    encoder = _tower(lambda: CLIPTextEncoder(cfg or CLIPTextConfig.vit_l_14()), dev)
    encoder.load_state_dict(state_dict)
    with torch.no_grad():
        out = encoder(torch.as_tensor(np.asarray(input_ids), device=dev))
    return out.last_hidden.cpu().numpy()


def _clip_text_checkpoint(src: str):
    """(config, state dict) of a transformers CLIP text model in a folder or
    the local Hugging Face cache; raises ``OSError`` where it is not on disk."""
    from transformers import CLIPTextConfig as HFCLIPTextConfig
    from transformers.utils import cached_file

    hf = HFCLIPTextConfig.from_pretrained(src, local_files_only=True)
    cfg = CLIPTextConfig(
        vocab_size=hf.vocab_size, hidden_size=hf.hidden_size, num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads, intermediate_size=hf.intermediate_size,
        max_position_embeddings=hf.max_position_embeddings, hidden_act=hf.hidden_act,
        # transformers pools by the highest id where a config says eos 2 (the original openai configs)
        eos_token_id=-1 if hf.eos_token_id == 2 else hf.eos_token_id, layer_norm_eps=hf.layer_norm_eps,
    )
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = cached_file(src, name, local_files_only=True, _raise_exceptions_for_missing_entries=False)
        if path:
            break
    else:
        raise OSError(f"{src}: no model.safetensors or pytorch_model.bin")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        state = load_file(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    return cfg, {k: v.float() for k, v in state.items() if k.startswith("text_model.")}


def encode_prompts(prompts, negative_prompts=None, model_name: str = "openai/clip-vit-large-patch14",
                   local_path: Optional[str] = None, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(cond, uncond): see :func:`encode_prompts_ex`."""
    return encode_prompts_ex(prompts, negative_prompts, model_name, local_path, device)[:2]


def encode_prompts_ex(prompts, negative_prompts=None, model_name: str = "openai/clip-vit-large-patch14",
                      local_path: Optional[str] = None, device="cuda") -> Tuple[np.ndarray, np.ndarray, bool]:
    """(cond, uncond, used_pseudo), each [B, 77, D] float32 (numpy).

    With a CLIP tokenizer and text model on disk (``local_path`` or the
    local Hugging Face cache of ``model_name``; never a download), the port's
    ``CLIPTextEncoder`` encodes on ``device`` with those weights. Where the
    package, the vocabulary or the weights are missing, the prompts enter as
    ``pseudo_text_embeddings``, as in the JAX function."""
    if negative_prompts is None:
        negative_prompts = [""] * len(prompts)
    if len(negative_prompts) != len(prompts):
        raise ValueError(f"{len(prompts)} prompts, {len(negative_prompts)} negative prompts")
    src = local_path or model_name
    try:
        from transformers import CLIPTokenizer

        tokenizer = CLIPTokenizer.from_pretrained(src, local_files_only=True)
        cfg, state = _clip_text_checkpoint(src)
    except (ImportError, OSError, TypeError):  # construction only: an encoding error raises
        return pseudo_text_embeddings(list(prompts)), pseudo_text_embeddings(list(negative_prompts)), True

    def enc(texts):
        ids = tokenizer(list(texts), padding="max_length", max_length=tokenizer.model_max_length, truncation=True,
                        return_tensors="np")["input_ids"]
        return encode_tokens(state, ids, cfg, device)

    return enc(prompts), enc(negative_prompts), False


def _unflatten(flat: dict) -> dict:
    """'a/b/c' keys -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


class T2ITowers:
    """The SD3 / Flux text towers, float32, on ``device`` (default: the card).

    ``scale``: ``"small"``, the real widths (768 / 1280 / 4096) at depth 2
    (T5's feed-forward 4096 wide); ``"full"``, the real architectures
    (CLIP-L with projection for SD3, without for Flux; CLIP-bigG; T5-XXL).
    Seeded random weights are drawn on the device (the modules are built on
    the meta device first): the CLIP towers N(0, 0.02) with norm scales 1,
    T5 at its own init scales (``init_t5_``); or ``load`` reads the JAX
    package's converted parameters."""

    def __init__(self, family: str = "sd3", scale: str = "small", seed: int = 0, clip_seq: int = 77,
                 t5_seq: int = 77, device="cuda"):
        if family not in ("sd3", "flux"):
            raise ValueError(f"family must be 'sd3' or 'flux', got {family!r}")
        # a typo must not build the full-scale towers (19 GB in float32)
        if scale not in ("small", "full"):
            raise ValueError(f"scale must be 'small' or 'full', got {scale!r}")
        self.family, self.clip_seq, self.t5_seq = family, clip_seq, t5_seq
        self.device = resolve_device(device)
        small = scale == "small"
        clip_l = CLIPTextConfig.vit_l_14_projected() if family == "sd3" else dataclasses.replace(
            CLIPTextConfig.vit_l_14(), eos_token_id=CLIP_EOS)
        clip_g = CLIPTextConfig.vit_bigg_14() if family == "sd3" else None
        t5 = T5Config.v1_1_xxl()
        if small:
            clip_l = dataclasses.replace(clip_l, num_layers=2)
            t5 = dataclasses.replace(t5, num_layers=2, d_ff=4096)
            if clip_g is not None:
                clip_g = dataclasses.replace(clip_g, num_layers=2)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.clip_l = init_normal_(_tower(lambda: CLIPTextEncoder(clip_l), self.device), gen)
        self.clip_g = None if clip_g is None else init_normal_(_tower(lambda: CLIPTextEncoder(clip_g), self.device), gen)
        self.t5 = init_t5_(_tower(lambda: T5Encoder(t5), self.device), gen)
        self.used_pseudo_tokens = False

    def load(self, params_dir) -> "T2ITowers":
        """Each tower's weights from ``<params_dir>/<name>.npz`` (``clip_l``,
        ``t5``, and ``clip_g`` for SD3): the JAX package's converted flax
        parameters with '/'-joined keys. A missing or extra key raises
        ``KeyError``, a shape other than the architecture's ``ValueError``;
        every tower must be there. JAX's orbax-directory form needs
        ``utils/checkpoint.py``, not ported yet."""
        base = Path(params_dir)
        towers = [("clip_l", self.clip_l, clip_text_state_dict_from_flax), ("t5", self.t5, t5_state_dict_from_flax)]
        if self.clip_g is not None:
            towers.append(("clip_g", self.clip_g, clip_text_state_dict_from_flax))
        for name, module, to_state_dict in towers:
            ckpt_dir, npz = base / name, base / f"{name}.npz"
            if ckpt_dir.is_dir():
                raise SystemExit(f"{ckpt_dir}: orbax checkpoint directories (utils/checkpoint.py) are not ported yet: "
                                 "ROADMAP.md queue 1, item 12")
            if not npz.is_file():
                raise FileNotFoundError(f"tower checkpoint missing: {npz}")
            with np.load(npz) as f:
                state = to_state_dict(_unflatten({k: f[k] for k in f.files}), module.cfg)
            want = module.state_dict()
            missing, extra = sorted(set(want) - set(state)), sorted(set(state) - set(want))
            if missing or extra:
                raise KeyError(f"{npz}: key mismatch vs architecture (missing {missing[:5]}, extra {extra[:5]})")
            bad = [f"{k}: {tuple(v.shape)} != {tuple(want[k].shape)}" for k, v in state.items() if v.shape != want[k].shape]
            if bad:
                raise ValueError(f"{name}: tensor shapes differ from the architecture: {bad[:5]}")
            module.load_state_dict(state)
        return self

    def encode(self, prompts: Sequence[str], clip_path=None, t5_path=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context [B, clip_seq + t5_seq, 4096], pooled [B, P]) float32 on
        the towers' device. SD3: the two CLIP penultimates side by side,
        zero-padded to T5's width, then the T5 hidden in sequence; pooled the
        projected CLIP-L and CLIP-bigG outputs (P = 2048; CLIP-bigG reads
        CLIP-L's ids). Flux: the T5 hidden; pooled CLIP-L's unprojected output
        at the first eos (P = 768)."""
        ids_l, p1 = _clip_tokenize(prompts, self.clip_seq, clip_path)
        ids_t5, p3 = _t5_tokenize(prompts, self.t5_seq, t5_path)
        self.used_pseudo_tokens = bool(p1 or p3)
        ids_l, ids_t5 = (torch.from_numpy(a).to(self.device) for a in (ids_l, ids_t5))
        with torch.no_grad():
            out_l = self.clip_l(ids_l)
            t5_hidden = self.t5(ids_t5)
            if self.family == "flux":
                return t5_hidden, out_l.pooled
            out_g = self.clip_g(ids_l)
            clip_ctx = torch.cat([out_l.penultimate, out_g.penultimate], dim=-1)
            clip_ctx = F.pad(clip_ctx, (0, self.t5.cfg.d_model - clip_ctx.shape[-1]))
            return torch.cat([clip_ctx, t5_hidden], dim=1), torch.cat([out_l.pooled, out_g.pooled], dim=-1)
