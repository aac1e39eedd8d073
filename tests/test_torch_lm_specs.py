"""The port's layouts (``lm_param_specs``, ``cache_specs``) and mesh helpers
(``dp_axis_names``, ``dp_size``, ``model_size``) against the reference's,
spec for spec, for the five LM archs (published configs and smoke
configs), kimi-k2's smoke config with ``fsdp=True`` and mixtral with 3
experts (expert-tensor-parallel), on meshes from 1×1 to the production
16×16 and 2×16×16.

Both packages read a mesh's ``axis_names`` and sizes only, so stand-ins
drive them at 256 and 512 ranks: the reference's ``mesh.shape`` maps axis
to size, the port's (as its ``Mesh``) is a tuple in axis order.

Every spec is equal but for the port's two deliberate differences, each
asserted exactly:
- KV heads that do not split over ``model`` are replicated: ``wk``/``wv``
  ``P(None, fs, None)`` and ``bk``/``bv`` ``P(None, None)``, where the
  reference names ``model`` (GSPMD splits inside heads);
- the decode cache ``[L, B, T, KV, hd]`` splits its batch over the data
  axes (when they divide it) and its KV heads over ``model`` (when they
  split), where the reference splits the sequence.
"""
import dataclasses
import types

import pytest

pytest.importorskip("torch")

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.mesh import P  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("qwen2-7b", "mixtral-8x7b", "qwen3-32b", "command-r-35b", "kimi-k2-1t-a32b")
VARIANTS = ARCHS + ("kimi-k2-fsdp", "mixtral-3-experts")
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4),
          "16x16": (16, 16), "2x16x16": (2, 16, 16)}


def _cfg(reg, variant: str, smoke: bool):
    arch = {"kimi-k2-fsdp": "kimi-k2-1t-a32b", "mixtral-3-experts": "mixtral-8x7b"}.get(
        variant, variant)
    cfg = reg.get_config(arch, smoke=smoke)
    if variant == "kimi-k2-fsdp":
        cfg = dataclasses.replace(cfg, fsdp=True)
    if variant == "mixtral-3-experts":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
    return cfg


def _meshes(shape):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return ref, types.SimpleNamespace(axis_names=axes, shape=tuple(shape))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


CASES = [(v, m, smoke) for v in VARIANTS for m in MESHES for smoke in (True, False)]
IDS = [f"{v}-{m}-{'smoke' if s else 'config'}" for v, m, s in CASES]


@pytest.mark.parametrize("variant,mesh,smoke", CASES, ids=IDS)
def test_param_specs_are_the_reference_s_but_replicated_kv_heads(variant, mesh, smoke):
    rmesh, tmesh = _meshes(MESHES[mesh])
    rcfg, cfg = _cfg(ref_registry, variant, smoke), _cfg(registry, variant, smoke)
    assert (T.dp_axis_names(tmesh), T.dp_size(tmesh), T.model_size(tmesh)) == (
        RT.dp_axis_names(rmesh), RT.dp_size(rmesh), RT.model_size(rmesh))
    want = {k: tuple(v) for k, v in _flat(RT.lm_param_specs(rcfg, rmesh)).items()}
    got = _flat(T.lm_param_specs(cfg, tmesh))
    assert all(isinstance(v, P) for v in got.values())
    got = {k: tuple(v) for k, v in got.items()}
    assert sorted(got) == sorted(want)
    differ = {k for k in want if got[k] != want[k]}
    replicated = cfg.n_kv_heads % T.model_size(tmesh) != 0
    kv_leaves = {"layers.wk", "layers.wv"} | ({"layers.bk", "layers.bv"} if cfg.qkv_bias else set())
    assert differ == (kv_leaves if replicated else set())
    for k in differ:  # the reference's spec with "model" taken off the KV dimension
        assert got[k] == want[k][:-1] + (None,) and want[k][-1] == "model", k


@pytest.mark.parametrize("variant,mesh", [(v, m) for v in VARIANTS for m in MESHES])
@pytest.mark.parametrize("batch", [1, 4, 96])
def test_cache_specs_split_batch_and_kv_heads_where_the_reference_splits_the_sequence(
        variant, mesh, batch):
    rmesh, tmesh = _meshes(MESHES[mesh])
    rcfg, cfg = _cfg(ref_registry, variant, False), _cfg(registry, variant, False)
    want = RT.cache_specs(rcfg, rmesh, batch)
    got = T.cache_specs(cfg, tmesh, batch)
    dp = RT.dp_axis_names(rmesh)
    dpn = RT.dp_size(rmesh)
    split_batch = dpn > 1 and batch % dpn == 0
    # the reference: the sequence over model (and the data axes unless they split the batch)
    seq = "model" if split_batch else (dp + ("model",))
    assert tuple(want["k"]) == tuple(P(None, dp if split_batch else None, seq, None, None))
    heads = "model" if cfg.n_kv_heads % T.model_size(tmesh) == 0 else None
    for k in ("k", "v"):
        assert isinstance(got[k], P)
        assert tuple(got[k]) == tuple(P(None, dp if split_batch else None, None, heads, None))


@pytest.mark.parametrize("variant", VARIANTS)
def test_check_mesh_names_the_limit_at_production_size(variant):
    """At 16-way ``model``, qwen2-7b's 28 query heads do not split: the port
    raises naming the limit (the reference's GSPMD splits inside heads;
    item 13c counts that layout without running it). Every other arch
    runs there, its 8 KV heads replicated in pairs."""
    for mesh in ("16x16", "2x16x16"):
        _, tmesh = _meshes(MESHES[mesh])
        cfg = _cfg(registry, variant, False)
        if variant == "qwen2-7b":
            with pytest.raises(ValueError, match="n_heads = 28 does not split over model = 16"):
                T.check_mesh(cfg, tmesh)
        else:
            T.check_mesh(cfg, tmesh)
            assert cfg.n_kv_heads % T.model_size(tmesh) != 0


@pytest.mark.parametrize("field,value,limit", [
    ("n_heads", 6, "n_heads = 6 does not split over model = 4"),
    ("n_kv_heads", 3, "n_kv_heads = 3 neither splits over model = 4 ranks nor divides it"),
    ("d_ff", 130, "d_ff = 130 does not split over model = 4"),
    ("vocab", 510, "vocab = 510 does not split over model = 4"),
])
def test_bad_splits_raise_value_error_naming_the_limit(field, value, limit):
    cfg = dataclasses.replace(registry.get_config("qwen2-7b", smoke=True), **{field: value})
    if field == "n_heads":
        cfg = dataclasses.replace(cfg, n_kv_heads=2, head_dim=16)
    _, tmesh = _meshes((2, 4))
    with pytest.raises(ValueError, match=limit.replace("(", r"\(").replace(")", r"\)")):
        T.check_mesh(cfg, tmesh)


def test_fsdp_needs_d_model_to_split_over_the_data_axes():
    cfg = dataclasses.replace(registry.get_config("kimi-k2-1t-a32b", smoke=True), fsdp=True,
                              d_model=66)
    _, tmesh = _meshes((4, 2))
    with pytest.raises(ValueError, match="FSDP: d_model = 66 does not split over the data "
                                         r"axes \(4 ranks\)"):
        T.check_mesh(cfg, tmesh)
