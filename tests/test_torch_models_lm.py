"""Parity of the port's LM (``repro_torch.models.transformer``) with the
reference's ``repro.models.transformer`` for the five LM smoke configs, on
the same numpy tokens and the reference's initial parameters carried
across (``from_reference``).

Tolerances: under ``dtype="float32"`` hidden states, logits, caches and
losses within rel 1e-5 of the largest reference entry (the same
operations; reductions and matmuls sum in other orders). Under the
configured bfloat16, tensors within 2^-5 of the largest reference entry
(bfloat16 spacing is 2^-8 to 2^-7 of a value; XLA on the CPU may keep
float32 between fused elementwise operations where torch rounds each to
bfloat16, so results round a few steps apart after two layers) and losses
within rel 2^-10. The prefill/decode agreement of the port alone takes
the reference test's 3e-2.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, one_torch_thread, to_np  # noqa: E402,F401
from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import from_reference, to_reference  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = [a for a in registry.arch_ids() if registry.family_of(a) == "lm"]
DTYPES = ["float32", "bfloat16"]
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -10}
B, S, PAD = 2, 40, 48  # the decode cache is right-padded to PAD slots
MESH = make_host_mesh()


def _cfgs(arch, dtype="float32", **kw):
    """(reference cfg, port cfg) for a smoke config with the same changes."""
    return tuple(dataclasses.replace(reg.get_config(arch, smoke=True), dtype=dtype, **kw)
                 for reg in (ref_registry, registry))


def _tokens(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pad_cache(cache, want):
    t = cache["k"].shape[2]
    if t >= want:
        return cache
    return {k: np.pad(v, ((0, 0), (0, 0), (0, want - t), (0, 0), (0, 0)))
            for k, v in cache.items()}


def _port_cache(cache, dtype):
    return {k: torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, dtype))
            for k, v in cache.items()}


def _model(ref_params, cfg):
    return from_reference(T.init_lm(cfg, device="cpu"), ref_params)


@pytest.fixture(scope="module")
def reference():
    """Per (arch, dtype), one jit: lm_forward (triangle_skip off and on),
    lm_loss with and without vocab_chunk, lm_prefill of the tokens and of
    their S−1 prefix, and lm_decode_step of the last token on that prefix's
    cache, right-padded to ``PAD`` slots (a window arch's stays rolled)."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            rcfg, _ = _cfgs(arch, dtype)
            chunked = dataclasses.replace(rcfg, vocab_chunk=128)
            params = RT.init_lm(jax.random.key(0), rcfg)
            toks, labels = _tokens(rcfg)

            def outs(p, toks, labels):
                _, pre_cache = RT.lm_prefill(p, toks[:, :-1], rcfg, MESH)
                t = pre_cache["k"].shape[2]
                want = PAD if rcfg.sliding_window is None else min(PAD, rcfg.sliding_window)
                padded = jax.tree.map(
                    lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, max(want - t, 0)), (0, 0), (0, 0))),
                    pre_cache)
                dec_logits, dec_cache = RT.lm_decode_step(p, toks[:, -1], padded,
                                                          jnp.int32(S - 1), rcfg, MESH)
                return dict(
                    hidden=RT.lm_forward(p, toks, rcfg, MESH).astype(jnp.float32),
                    hidden_skip=RT.lm_forward(p, toks, rcfg, MESH,
                                              triangle_skip=True).astype(jnp.float32),
                    loss=RT.lm_loss(p, toks, labels, rcfg, MESH),
                    loss_chunked=RT.lm_loss(p, toks, labels, chunked, MESH),
                    prefill=RT.lm_prefill(p, toks, rcfg, MESH),
                    prefix_cache=padded, dec_logits=dec_logits, dec_cache=dec_cache)

            cache[(arch, dtype)] = dict(params=_np(params), toks=toks, labels=labels,
                                        **_np(jax.jit(outs)(params, toks, labels)))
        return cache[(arch, dtype)]

    return get


def _close(got, want, dtype):
    assert_rel_close(to_np(got.float() if isinstance(got, torch.Tensor) else got),
                     np.asarray(want, np.float32), REL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_tree_and_round_trips(arch):
    rcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: RT.init_lm(k, rcfg), jax.random.key(0))
    model = T.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    got = jax.tree.map(lambda p: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32),
                       model.params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    assert all(p.requires_grad for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert {n for n, _ in model.named_parameters()} == {
        ".".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]}
    ref = _np(RT.init_lm(jax.random.key(0), rcfg))
    back = to_reference(from_reference(model, ref))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        from_reference(model, {**ref, "layers": {**ref["layers"], "extra": np.zeros(1)}})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(reference, arch, dtype):
    ref = reference(arch, dtype)
    _, cfg = _cfgs(arch, dtype)
    p = _model(ref["params"], cfg).params
    toks, labels = torch.tensor(ref["toks"]), torch.tensor(ref["labels"])
    with torch.no_grad():
        _close(T.lm_forward(p, toks, cfg), ref["hidden"], dtype)
        _close(T.lm_forward(p, toks, cfg, triangle_skip=True), ref["hidden_skip"], dtype)
        for key, c in (("loss", cfg), ("loss_chunked", dataclasses.replace(cfg, vocab_chunk=128))):
            loss = T.lm_loss(p, toks, labels, c)
            assert loss.dtype == torch.float32 and loss.shape == ()
            assert_rel_close(loss, ref[key], LOSS_REL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode(reference, arch, dtype):
    ref = reference(arch, dtype)
    _, cfg = _cfgs(arch, dtype)
    p = _model(ref["params"], cfg).params
    logits, cache = T.lm_prefill(p, torch.tensor(ref["toks"]), cfg)
    want_logits, want_cache = ref["prefill"]
    assert logits.dtype == torch.float32 and cache["k"].dtype == getattr(torch, dtype)
    _close(logits, want_logits, dtype)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == want_cache[k].shape
        _close(cache[k], want_cache[k], dtype)
    # decode on the reference's own prefix cache: isolates the decode step
    cache = _port_cache(ref["prefix_cache"], dtype)
    logits, out = T.lm_decode_step(p, torch.tensor(ref["toks"][:, -1]), cache, S - 1, cfg)
    assert out["k"] is cache["k"]  # written in place
    _close(logits, ref["dec_logits"], dtype)
    for k in ("k", "v"):
        _close(out[k], ref["dec_cache"][k], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_parity(arch):
    """The reference test's check on the port alone: last-token logits of a
    full prefill against a decode of the last token on the S−1 prefix's
    cache, under the configured bfloat16."""
    cfg = registry.get_config(arch, smoke=True)
    p = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu").params
    toks = torch.tensor(_tokens(cfg, s=32)[0])
    full, _ = T.lm_prefill(p, toks, cfg)
    _, cache = T.lm_prefill(p, toks[:, :-1], cfg)
    want_t = min(cfg.sliding_window or 32, 32)
    if cache["k"].shape[2] < want_t:
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, want_t - v.shape[2]))
                 for k, v in cache.items()}
    dec, _ = T.lm_decode_step(p, toks[:, -1], cache, 31, cfg)
    assert float((full - dec).abs().max()) < 3e-2


def test_cache_shape_matches_the_reference():
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch, "bfloat16")
        for b, t in ((1, 8), (3, 100)):
            want = RT.cache_shape(rcfg, b, t)
            got = T.cache_shape(cfg, b, t)
            for k in ("k", "v"):
                assert got[k].shape == want[k].shape
                assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# the cases no smoke config reaches by itself
# ---------------------------------------------------------------------------

def _jit_ref(fn, *args):
    return _np(jax.jit(fn)(*args))


def test_moe_tokens_over_capacity():
    """capacity_factor 0.5 on mixtral's smoke config: cap = 16 slots per
    expert for 64 tokens × top-2 over 4 experts, so most experts drop
    routed tokens; the same ones on both sides."""
    rcfg, cfg = _cfgs("mixtral-8x7b")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=0.5))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params = _np(RT.init_lm(jax.random.key(2), rcfg))
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = np.random.default_rng(5).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = _jit_ref(lambda x, lp: RT.moe_block(x, lp, rcfg, MESH), x, lp)
    got = T.moe_block(torch.tensor(x), {k: torch.tensor(v) for k, v in lp.items()}, cfg)
    # the routed counts exceed the capacity
    probs = torch.softmax(torch.tensor(x).reshape(-1, cfg.d_model) @ torch.tensor(lp["router"]),
                          -1)
    routed = torch.bincount(torch.topk(probs, 2).indices.reshape(-1), minlength=4)
    assert int(routed.max()) > 16
    assert_rel_close(got, want, 1e-5)
    # the whole model at that capacity
    toks, labels = _tokens(cfg)
    want_loss = _jit_ref(lambda p, t, l: RT.lm_loss(p, t, l, rcfg, MESH), params, toks, labels)
    p = _model(params, cfg).params
    with torch.no_grad():
        assert_rel_close(T.lm_loss(p, torch.tensor(toks), torch.tensor(labels), cfg),
                         want_loss, 1e-5)


def test_top_k_takes_the_lower_index_among_ties():
    x = torch.tensor([[0.0, 1.0, 1.0, 0.5, 1.0], [0.0] * 5])
    vals, idx = T._top_k(x, 3)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_shared_experts():
    """n_shared=1, which no shipped config sets: the shared FFN's weights
    and its sum into the routed output."""
    rcfg, cfg = _cfgs("kimi-k2-1t-a32b")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, n_shared=1))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=1))
    params = _np(RT.init_lm(jax.random.key(4), rcfg))
    assert {"swi", "swg", "swo"} <= set(params["layers"])
    toks, labels = _tokens(cfg)
    want_x, want_loss = _jit_ref(lambda p, t, l: (RT.lm_forward(p, t, rcfg, MESH),
                                                  RT.lm_loss(p, t, l, rcfg, MESH)),
                                 params, toks, labels)
    p = _model(params, cfg).params
    with torch.no_grad():
        assert_rel_close(T.lm_forward(p, torch.tensor(toks), cfg), want_x, 1e-5)
        assert_rel_close(T.lm_loss(p, torch.tensor(toks), torch.tensor(labels), cfg),
                         want_loss, 1e-5)


def test_window_prompt_longer_than_the_window_then_decodes_past_it():
    """mixtral's smoke window is 32: a 45-token prompt rolls the cache
    (token p at slot p % 32), and 12 decodes wrap it again."""
    rcfg, cfg = _cfgs("mixtral-8x7b")
    params = _np(RT.init_lm(jax.random.key(0), rcfg))
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 57)).astype(np.int32)
    prompt = toks[:, :45]
    ref_prefill = jax.jit(lambda p, t: RT.lm_prefill(p, t, rcfg, MESH))
    ref_decode = jax.jit(lambda p, tok, c, pos: RT.lm_decode_step(p, tok, c, pos, rcfg, MESH))
    want_logits, want_cache = ref_prefill(params, prompt)
    p = _model(params, cfg).params
    logits, cache = T.lm_prefill(p, torch.tensor(prompt), cfg)
    assert cache["k"].shape[2] == 32
    assert_rel_close(logits, want_logits, 1e-5)
    for k in ("k", "v"):
        assert_rel_close(cache[k], want_cache[k], 1e-5)
    for i in range(45, 57):
        want_logits, want_cache = ref_decode(params, toks[:, i], want_cache, jnp.int32(i))
        logits, cache = T.lm_decode_step(p, torch.tensor(toks[:, i]), cache, i, cfg)
        assert_rel_close(logits, want_logits, 1e-5)
    for k in ("k", "v"):
        assert_rel_close(cache[k], want_cache[k], 1e-5)
    # and against the port's own full prefill of all 57 tokens
    full, _ = T.lm_prefill(p, torch.tensor(toks), cfg)
    assert_rel_close(logits, full, 1e-4)


def test_decode_past_the_cache_clamps_its_write():
    """No window: a decode at pos >= T writes slot T − 1 and attends to
    every slot, as the reference's dynamic_update_slice clamps."""
    rcfg, cfg = _cfgs("qwen2-7b")
    params = _np(RT.init_lm(jax.random.key(0), rcfg))
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref_decode = jax.jit(lambda p, tok, c, pos: RT.lm_decode_step(p, tok, c, pos, rcfg, MESH))
    _, want_cache = jax.jit(lambda p, t: RT.lm_prefill(p, t, rcfg, MESH))(params, toks)
    p = _model(params, cfg).params
    cache = _port_cache(_np(want_cache), "float32")
    for pos, tok in ((16, 3), (21, 7)):
        tok = np.full((2,), tok, np.int32)
        want_logits, want_cache = ref_decode(params, tok, want_cache, jnp.int32(pos))
        logits, cache = T.lm_decode_step(p, torch.tensor(tok), cache, pos, cfg)
        assert_rel_close(logits, want_logits, 1e-5)
        for k in ("k", "v"):
            assert_rel_close(cache[k], want_cache[k], 1e-5)


def test_token_ids_out_of_range_are_clipped():
    rcfg, cfg = _cfgs("qwen3-32b")
    params = _np(RT.init_lm(jax.random.key(0), rcfg))
    toks, labels = _tokens(cfg, s=16)
    toks[0, :3] = [-5, cfg.vocab, cfg.vocab + 1000]
    want_x, (want_pl, want_pc) = _jit_ref(
        lambda p, t: (RT.lm_forward(p, t, rcfg, MESH), RT.lm_prefill(p, t, rcfg, MESH)),
        params, toks)
    p = _model(params, cfg).params
    with torch.no_grad():
        assert_rel_close(T.lm_forward(p, torch.tensor(toks), cfg), want_x, 1e-5)
    logits, cache = T.lm_prefill(p, torch.tensor(toks), cfg)
    assert_rel_close(logits, want_pl, 1e-5)
    tok = np.array([-1, cfg.vocab + 3], np.int32)
    padded = _pad_cache(want_pc, 20)
    want = _jit_ref(lambda p, tok, c: RT.lm_decode_step(p, tok, c, jnp.int32(16), rcfg, MESH)[0],
                    params, tok, padded)
    got, _ = T.lm_decode_step(p, torch.tensor(tok), _port_cache(padded, "float32"), 16, cfg)
    assert_rel_close(got, want, 1e-5)


def test_remat_changes_no_value_or_gradient():
    _, cfg = _cfgs("mixtral-8x7b")
    model = T.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks, labels = map(torch.tensor, _tokens(cfg, s=24))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss = T.lm_loss(model.params, toks, labels, c)
        out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    with torch.no_grad():  # the module's forward is lm_forward on its params
        assert torch.equal(model(toks), T.lm_forward(model.params, toks, cfg))


def test_one_rank_meshes_run_and_sharded_ones_raise():
    """A one-rank mesh runs the one-device program; a mesh whose ``model``
    axis does not divide the heads (qwen2-7b's smoke config has 4 query
    and 2 KV heads) raises ``ValueError`` naming the limit before any
    collective, on every entry point."""
    from repro_torch.launch.mesh import make_host_mesh

    _, cfg = _cfgs("qwen2-7b")
    p = T.init_lm(cfg, device="cpu").params
    toks = torch.zeros((1, 4), dtype=torch.int32)
    one = make_host_mesh(device="cpu")  # a world-1 gloo group, kept by the worker
    want, _ = T.lm_prefill(p, toks, cfg)
    assert torch.equal(T.lm_prefill(p, toks, cfg, one)[0], want)
    for shape, limit in (((1, 3), "n_heads = 4 does not split over model = 3"),
                         ((2, 8), "n_heads = 4 does not split over model = 8")):
        mesh = types.SimpleNamespace(axis_names=("data", "model"), shape=shape)
        for call in (lambda: T.lm_forward(p, toks, cfg, mesh),
                     lambda: T.lm_prefill(p, toks, cfg, mesh)):
            with pytest.raises(ValueError, match=limit):
                call()


def test_entry_points_want_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm(registry.get_config("qwen2-7b", smoke=True))
