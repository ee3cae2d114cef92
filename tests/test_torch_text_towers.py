"""The port's text towers against the JAX package, float32 on the CPU: the
CLIP text encoder (each activation and pooling mode, projection,
penultimate) and the T5 encoder (gated-gelu and relu, with and without a
mask) with weights carried from JAX parameters by the inverse converters
(exact round trips), the relative-position buckets and pseudo token ids bit
for bit, ``T2ITowers.encode`` for SD3 and Flux at narrow widths with the real
vocabularies, ``T2ITowers.load`` from JAX-written npz files and its errors,
``encode_prompts_ex`` (the fallback, and a tokenizer and text model saved to
a folder), the full-size parameter counts (meta device against JAX's
``eval_shape``), and that the slice's modules import no JAX. Torch runs on
one intra-op thread; 73 s on one worker under the suite's 6-worker run."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_uncertainty_torch.models.clip_text as tclip
import diffusion_uncertainty_torch.models.t5_text as tt5
import diffusion_uncertainty_torch.pipelines.text_encoder as tte
import diffusion_uncertainty_tpu.models.clip_text as jclip
import diffusion_uncertainty_tpu.models.t5_text as jt5
import diffusion_uncertainty_tpu.pipelines.text_encoder as jte
from diffusion_uncertainty_torch.models import clip_text_state_dict_from_flax, t5_state_dict_from_flax
from diffusion_uncertainty_tpu.models.convert import convert_clip_text, convert_t5_encoder

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REL = 1e-5  # float32 both sides; matmuls summed in another order


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _moved(params, seed: int):
    """JAX init moved by 0.05·N(0, 1) per leaf (norm scales off 1, biases off 0)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)


def _same_tree(a, b) -> None:
    fa, fb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("act,eos,proj", [("quick_gelu", -1, 0), ("quick_gelu", 7, 24), ("gelu", -1, 24), ("gelu", 7, 0)],
                         ids=["quick_gelu-argmax", "quick_gelu-eos-proj", "gelu-argmax-proj", "gelu-eos"])
def test_clip_text_tiny_matches_jax(act, eos, proj):
    jcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), hidden_act=act, eos_token_id=eos, projection_dim=proj)
    tcfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(), hidden_act=act, eos_token_id=eos, projection_dim=proj)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 90, size=(3, 12)).astype(np.int32)
    ids[:, 5] = 7  # an eos mid-sequence; argmax pooling reads the highest id instead
    ids[1, 2] = 7
    params = _moved(jclip.CLIPTextEncoder(jcfg).init(jax.random.key(0), jnp.asarray(ids)), 2)
    ref = jclip.CLIPTextEncoder(jcfg).apply(params, jnp.asarray(ids))
    sd = clip_text_state_dict_from_flax(params, tcfg)
    model = tclip.CLIPTextEncoder(tcfg).eval()
    model.load_state_dict(sd)  # strict: transformers' keys and shapes
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    for name in ("last_hidden", "pooled", "penultimate"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape and _rel(got, want) <= REL, name
    _same_tree(convert_clip_text({k: v.numpy() for k, v in sd.items()}, jcfg), params)
    # transformers' position_ids buffer in a checkpoint is dropped on load
    model.load_state_dict({**sd, "text_model.embeddings.position_ids": torch.arange(16)[None]})


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("ff", ["gated-gelu", "relu"])
def test_t5_tiny_matches_jax(ff, masked):
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), feed_forward_proj=ff)
    tcfg = dataclasses.replace(tt5.T5Config.tiny(), feed_forward_proj=ff)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 64, size=(2, 30)).astype(np.int32)  # 30 tokens: past max_distance 20, every bucket kind
    mask = np.ones((2, 30), bool)
    mask[1, 17:] = False
    params = _moved(jt5.T5Encoder(jcfg).init(jax.random.key(1), jnp.asarray(ids)), 4)
    ref = jt5.T5Encoder(jcfg).apply(params, jnp.asarray(ids), jnp.asarray(mask) if masked else None)
    sd = t5_state_dict_from_flax(params, tcfg)
    model = tt5.T5Encoder(tcfg).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None)
    assert out.shape == (2, 30, 32) and _rel(out.numpy(), ref) <= REL
    _same_tree(convert_t5_encoder({k: v.numpy() for k, v in sd.items()}, jcfg), params)
    model.load_state_dict({**sd, "encoder.embed_tokens.weight": sd["shared.weight"]})  # transformers' alias


def test_buckets_and_pseudo_token_ids_bit_equal():
    for length, nb, md in ((77, 32, 128), (300, 32, 128), (30, 8, 20), (5, 8, 20)):
        rel = np.arange(length)[None, :] - np.arange(length)[:, None]
        np.testing.assert_array_equal(tt5.rel_pos_bucket(rel, nb, md), jt5._rel_pos_bucket(rel, nb, md))
    prompts = ["a photo of a cat", "", "one two three four five six seven eight nine ten"]
    for args in ((77, tte.CLIP_VOCAB, tte.CLIP_VOCAB - 2, tte.CLIP_EOS), (77, tte.T5_VOCAB, None, 1), (4, 99, None, None)):
        np.testing.assert_array_equal(tte.pseudo_token_ids(prompts, *args[:2], bos=args[2], eos=args[3]),
                                      jte.pseudo_token_ids(prompts, *args[:2], bos=args[2], eos=args[3]))
    assert (tte.CLIP_VOCAB, tte.CLIP_EOS, tte.T5_VOCAB) == (jte.CLIP_VOCAB, jte.CLIP_EOS, jte.T5_VOCAB)


def _narrow(monkeypatch):
    """Both packages' tower factories at narrow widths with the real
    vocabularies (pseudo ids are drawn over 49408 and 32128 ids) and 77
    positions."""
    clip = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    big = dict(hidden_size=48, num_layers=3, num_heads=3, intermediate_size=96, hidden_act="gelu", eos_token_id=49407,
               projection_dim=40)
    t5 = dict(d_model=96, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
    for mod in (jclip, tclip):
        c = mod.CLIPTextConfig
        monkeypatch.setattr(c, "vit_l_14", staticmethod(lambda c=c: c(**clip)))
        monkeypatch.setattr(c, "vit_l_14_projected", staticmethod(lambda c=c: c(**clip, eos_token_id=49407, projection_dim=24)))
        monkeypatch.setattr(c, "vit_bigg_14", staticmethod(lambda c=c: c(**big)))
    for mod in (jt5, tt5):
        monkeypatch.setattr(mod.T5Config, "v1_1_xxl", staticmethod(lambda c=mod.T5Config: c(**t5)))


def _carry(jt, tt) -> None:
    """The JAX towers' weights into the port's."""
    pairs = [(tt.clip_l, jt.clip_l_params, jt.clip_l_cfg, clip_text_state_dict_from_flax),
             (tt.t5, jt.t5_params, jt.t5_cfg, t5_state_dict_from_flax)]
    if jt.clip_g is not None:
        pairs.append((tt.clip_g, jt.clip_g_params, jt.clip_g_cfg, clip_text_state_dict_from_flax))
    for module, params, jcfg, to_sd in pairs:
        module.load_state_dict(to_sd(params, module.cfg))
        assert {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"} == dataclasses.asdict(module.cfg)


@pytest.mark.parametrize("family,scale", [("sd3", "small"), ("flux", "full")])
def test_towers_encode_matches_jax(monkeypatch, family, scale):
    _narrow(monkeypatch)
    jt = jte.T2ITowers(family, scale=scale, seed=3, t5_seq=20)
    tt = tte.T2ITowers(family, scale=scale, seed=3, t5_seq=20, device="cpu")
    _carry(jt, tt)
    prompts = ["a photo of a cat", ""]
    (ctx, pooled), (jctx, jpooled) = tt.encode(prompts), jt.encode(prompts)
    want = ((2, 77 + 20, 96), (2, 24 + 40)) if family == "sd3" else ((2, 20, 96), (2, 32))
    assert (tuple(ctx.shape), tuple(pooled.shape)) == (jctx.shape, jpooled.shape) == want
    assert tt.used_pseudo_tokens is jt.used_pseudo_tokens is True  # no tokenizer files on this box
    assert _rel(ctx.numpy(), jctx) <= REL and _rel(pooled.numpy(), jpooled) <= REL
    if family == "sd3":  # the CLIP block zero-padded past 32 + 48 features
        assert not ctx[:, :77, 80:].any()


def _write_npz(jt, root: Path) -> None:
    """Each JAX tower's parameters as JAX ``T2ITowers.load`` reads them."""
    for name in ("clip_l", "t5", "clip_g"):
        params = getattr(jt, f"{name}_params")
        if params is not None:
            leaves = jax.tree_util.tree_flatten_with_path(params)[0]
            np.savez(root / f"{name}.npz", **{"/".join(str(k.key) for k in p): np.asarray(v) for p, v in leaves})


def test_towers_load_from_jax_npz(monkeypatch, tmp_path):
    _narrow(monkeypatch)
    src = jte.T2ITowers("sd3", scale="small", seed=5, t5_seq=12)
    src.clip_l_params, src.clip_g_params, src.t5_params = (
        _moved(p, i) for i, p in enumerate((src.clip_l_params, src.clip_g_params, src.t5_params)))
    _write_npz(src, tmp_path)
    jt = jte.T2ITowers("sd3", scale="small", seed=6, t5_seq=12).load(tmp_path)
    tt = tte.T2ITowers("sd3", scale="small", seed=6, t5_seq=12, device="cpu").load(tmp_path)
    (ctx, pooled), (jctx, jpooled) = tt.encode(["a cat"]), jt.encode(["a cat"])
    assert _rel(ctx.numpy(), jctx) <= REL and _rel(pooled.numpy(), jpooled) <= REL

    def broken(edit):
        bad = tmp_path / edit
        bad.mkdir()
        for f in tmp_path.glob("*.npz"):
            arrays = dict(np.load(f))
            if f.stem == "clip_l":
                if edit == "missing":
                    del arrays["params/final_layer_norm/scale"]
                elif edit == "extra":
                    arrays["params/layer_0/spare"] = np.zeros(3, np.float32)
                else:
                    arrays["params/position_embedding"] = arrays["params/position_embedding"][:40]
            np.savez(bad / f.name, **arrays)
        return bad

    for edit, err in (("missing", KeyError), ("extra", KeyError), ("shape", ValueError)):
        bad = broken(edit)
        for towers in (jte.T2ITowers("sd3", scale="small", t5_seq=12),
                       tte.T2ITowers("sd3", scale="small", t5_seq=12, device="cpu")):
            with pytest.raises(err):
                towers.load(bad)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tt.load(empty)
    (empty / "clip_l").mkdir()  # JAX's orbax-directory form
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1, item 12"):
        tt.load(empty)
    with pytest.raises(ValueError, match="scale"):
        tte.T2ITowers("sd3", scale="smal", device="cpu")
    with pytest.raises(AssertionError):
        jte.T2ITowers("sd3", scale="smal")


def test_encode_prompts_ex_fallback_equals_jax(tmp_path):
    missing = str(tmp_path / "no_clip_here")
    got = tte.encode_prompts_ex(["a photo of a cat"], ["blurry"], local_path=missing, device="cpu")
    want = jte.encode_prompts_ex(["a photo of a cat"], ["blurry"], local_path=missing)
    assert got[2] is want[2] is True
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == (1, 77, 768)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tte.encode_prompts(["x"], device="cpu")[0], jte.encode_prompts(["x"])[0])


def test_encode_prompts_ex_with_a_saved_clip_matches_jax(tmp_path):
    """A tokenizer and a CLIP text model saved to a folder: JAX encodes with
    transformers' torch model, the port with its own tower and the folder's
    weights."""
    import json
    import string

    import transformers

    vocab = {c: i for i, c in enumerate(string.ascii_lowercase)}
    vocab.update({c + "</w>": 26 + i for i, c in enumerate(string.ascii_lowercase)})
    vocab.update({"<|startoftext|>": 52, "<|endoftext|>": 53})
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 8}))
    torch.manual_seed(0)
    hf = transformers.CLIPTextConfig(vocab_size=54, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                     num_attention_heads=2, max_position_embeddings=8)
    transformers.CLIPTextModel(hf).save_pretrained(tmp_path)
    got = tte.encode_prompts_ex(["a photo of a cat"], local_path=str(tmp_path), device="cpu")
    want = jte.encode_prompts_ex(["a photo of a cat"], local_path=str(tmp_path))
    assert got[2] is want[2] is False
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape == (1, 8, 32) and _rel(a, b) <= REL


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card the towers, the CLIP encoding and the safety checker
    raise unless asked for the CPU; they never fall back."""
    from diffusion_uncertainty_torch.pipelines.safety_checker import load_safety_checker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tte.T2ITowers("flux"), lambda: tte.encode_tokens({}, np.zeros((1, 4), np.int32)),
                 lambda: load_safety_checker({})):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


@pytest.mark.parametrize("which,count", [("vit_l_14", 123_060_480), ("vit_l_14_projected", 123_650_304),
                                         ("vit_bigg_14", 694_659_840), ("t5_xxl", 4_762_310_656)])
def test_full_size_parameter_counts(which, count):
    if which == "t5_xxl":
        jmodel, make = jt5.T5Encoder(jt5.T5Config.v1_1_xxl()), lambda: tt5.T5Encoder(tt5.T5Config.v1_1_xxl())
    else:
        jmodel = jclip.CLIPTextEncoder(getattr(jclip.CLIPTextConfig, which)())
        make = lambda: tclip.CLIPTextEncoder(getattr(tclip.CLIPTextConfig, which)())  # noqa: E731
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 77), jnp.int32))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == count
    with torch.device("meta"):
        assert sum(p.numel() for p in make().parameters()) == count


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
for m in ("diffusion_uncertainty_torch.models.clip_text", "diffusion_uncertainty_torch.models.t5_text",
          "diffusion_uncertainty_torch.models.clip_vision", "diffusion_uncertainty_torch.models.convert",
          "diffusion_uncertainty_torch.models.sd_unet",
          "diffusion_uncertainty_torch.pipelines.text_encoder", "diffusion_uncertainty_torch.pipelines.safety_checker",
          "diffusion_uncertainty_torch.scripts.generate_t2i_guided", "diffusion_uncertainty_torch.scripts.profile_forward",
          "chip_smoke"):
    importlib.import_module(m)
import numpy as np, torch
from diffusion_uncertainty_torch.factory import init_normal_
from diffusion_uncertainty_torch.models import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, T5Config, T5Encoder
from diffusion_uncertainty_torch.pipelines import SafetyChecker, run_safety_checker, pseudo_token_ids
ids = torch.from_numpy(pseudo_token_ids(["a cat"], 8, 64, eos=1))
with torch.no_grad():
    out = CLIPTextEncoder(CLIPTextConfig.tiny())(ids)
    h = T5Encoder(T5Config.tiny())(ids)
    sc = init_normal_(SafetyChecker(CLIPVisionConfig.tiny()), torch.Generator().manual_seed(0))
    images, flags = run_safety_checker(sc, torch.rand(2, 20, 24, 3))
assert out.pooled.shape == (1, 32) and h.shape == (1, 8, 32) and flags.shape == (2,) and images.shape == (2, 20, 24, 3)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_slice_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
