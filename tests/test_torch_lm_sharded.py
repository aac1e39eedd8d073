"""Parity of the port's mesh-sharded LM with the reference's on the same
mesh shape: ``repro.models.transformer`` and ``repro.train.steps`` under
``jax.jit`` on 2, 4 and 8 forced host devices (one subprocess per mesh,
one jit per case), against gloo rank groups of 2, 4 and 8 processes
(``_torch_util.start_ranks``) running ``repro_torch`` at 1×2, 2×2 and 2×4
``("data", "model")``.

Cases: the five LM smoke configs in float32, kimi-k2 with ``fsdp=True``
and ``grad_accum=2`` (the FSDP variant), mixtral with 3 experts (expert-tensor-parallel: 3
experts do not split over ``model`` = 2 or 4) and qwen2-7b in bfloat16; at 2×2 and 2×4
also qwen2-7b and mixtral on a batch of 3, which the two data ranks do not
split (each computes the whole batch: the loss, the MoE capacity and the
cache then cover all rows on every rank). Their oracle is the reference on
one device, which runs the same whole batch: the reference's GSPMD program
on 2×2 and 2×4 pads the batch to 4 and adds the padding row's gradient to
row 0 of the embedding (0.923 where one device has 0.087 in
``qwen2-7b-odd-batch``; ROADMAP Queue 3), all else within 1e-7.
The weights, AdamW moments and batch are numpy draws, the same for both
packages. The MoE capacity is per data shard in both (so a 2×2 run is
compared with the reference's 2×2 run, not with a 1×1 one), and at 2×4
qwen2/qwen3/command-r/mixtral replicate their 2 KV heads over 4 ranks.

Compared: the loss and every gradient leaf of ``lm_loss_and_grad``
(gathered), the params and ``gnorm`` of one ``lm_train_step`` from an
AdamW state past warm-up, the prefill logits and cache (gathered) of a
36-token prompt, and 4 decode steps' logits and final cache (mixtral's
32-token window rolls). Logits and loss are the same on every rank.

Tolerances: float32 tensors within rel 1e-5 of the largest entry of the
reference's tensor (per gradient leaf: of the larger of its own largest
entry and 1e-3 of the whole gradient tree's, since the key biases'
gradients are zero up to rounding: softmax ignores a shift shared by all
keys); losses and ``gnorm`` within rel 1e-5. bfloat16 (PR 20's): tensors
and ``gnorm`` within 2^-5, the loss within rel 2^-10.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_util import assert_rel_close, join_ranks, one_torch_thread, start_ranks  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x4": (2, 4)}
CONFIGS = ("qwen2-7b", "mixtral-8x7b", "qwen3-32b", "command-r-35b", "kimi-k2-1t-a32b",
           "kimi-k2-fsdp", "mixtral-3-experts", "qwen2-7b-bf16")
# Cases on a batch the data axes do not split, run where dp > 1.
ODD_BATCH_CONFIGS = ("qwen2-7b-odd-batch", "mixtral-8x7b-odd-batch")
ODD_BATCH_MESHES = ("2x2", "2x4")
B, ODD_B, S, PROMPT, DECODE = 4, 3, 40, 36, 4
STEP = 150  # the AdamW state's step: past the 100-step warm-up, so lr > 0
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -10}
CKPT_ARCH, CKPT_STEPS, REF_CKPT_STEP = "qwen2-7b", 3, 7
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def mesh_cases(mesh: str) -> tuple:
    """The cases run on ``mesh``."""
    return CONFIGS + (ODD_BATCH_CONFIGS if mesh in ODD_BATCH_MESHES else ())


def make_cfg(registry, name: str):
    """The case ``name``'s config from either package's registry."""
    arch = {"kimi-k2-fsdp": "kimi-k2-1t-a32b", "mixtral-3-experts": "mixtral-8x7b",
            "qwen2-7b-bf16": "qwen2-7b"}.get(name, name.removesuffix("-odd-batch"))
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="bfloat16" if name.endswith("bf16") else "float32")
    if name == "kimi-k2-fsdp":  # with the published config's microbatching too
        cfg = dataclasses.replace(cfg, fsdp=True, grad_accum=2)
    if name == "mixtral-3-experts":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
    return cfg


def _draw_tree(tree, rng, fn):
    return {k: _draw_tree(v, rng, fn) if isinstance(v, dict) else fn(k, v.shape)
            for k, v in sorted(tree.items())}


def make_inputs(seed: int = 0) -> dict:
    """Per case: whole weights (norm scales near 1, the rest N(0, 0.05²)),
    AdamW moments and a batch of global tokens and labels, as numpy."""
    from repro_torch.configs import registry
    from repro_torch.models import to_reference
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(seed)
    out = {}
    for name in CONFIGS + ODD_BATCH_CONFIGS:
        cfg = make_cfg(registry, name)
        b = ODD_B if name in ODD_BATCH_CONFIGS else B
        shapes = to_reference(T.init_lm(dataclasses.replace(cfg, dtype="float32"),
                                        device="cpu"))

        def weight(k, shape):
            if k in NORMS:
                return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
            return (0.05 * rng.standard_normal(shape)).astype(np.float32)

        out[name] = dict(
            params=_draw_tree(shapes, rng, weight),
            mu=_draw_tree(shapes, rng, lambda k, s: (1e-3 * rng.standard_normal(s))
                          .astype(np.float32)),
            nu=_draw_tree(shapes, rng, lambda k, s: (1e-4 * rng.random(s) + 1e-6)
                          .astype(np.float32)),
            toks=rng.integers(0, cfg.vocab, (b, S)).astype(np.int32),
            labels=rng.integers(0, cfg.vocab, (b, S)).astype(np.int32))
    return out


def _cache_len(cfg) -> int:
    t = PROMPT + DECODE
    return t if cfg.sliding_window is None else min(t, cfg.sliding_window)


_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
sys.path.insert(0, "tests")
from test_torch_lm_sharded import (DECODE, MESHES, ODD_BATCH_CONFIGS, PROMPT, STEP, _cache_len,
                                   make_cfg, mesh_cases)
from repro.configs import registry
from repro.models import transformer as T
from repro.optim.adamw import AdamWState
from repro.train import steps as S

mname = sys.argv[3]
shape = MESHES[mname]
assert jax.device_count() == int(np.prod(shape)), jax.device_count()
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
out = {}
meshes = {False: Mesh(np.array(jax.devices()).reshape(shape), ("data", "model")),
          True: Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))}
for name in mesh_cases(mname):
    mesh = meshes[name in ODD_BATCH_CONFIGS]
    cfg = make_cfg(registry, name)
    inp = inputs[name]
    specs = T.lm_param_specs(cfg, mesh)

    def put(tree):
        return jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs,
                            tree, is_leaf=lambda s: isinstance(s, PartitionSpec))

    def outs(p, o, toks, labels):
        loss, grads = S.lm_loss_and_grad(p, toks, labels, cfg, mesh)
        p2, _, gnorm, _ = S._apply_opt(p, o, grads, o.step)
        logits, cache = T.lm_prefill(p, toks[:, :PROMPT], cfg, mesh)
        t = cache["k"].shape[2]
        cache = jax.tree.map(lambda c: jnp.pad(
            c, ((0, 0), (0, 0), (0, _cache_len(cfg) - t), (0, 0), (0, 0))), cache)

        def decode(c, i):  # one compiled step for the 4
            lg, c = T.lm_decode_step(p, toks[:, PROMPT + i], c, PROMPT + i, cfg, mesh)
            return c, lg

        dec_cache, dec = jax.lax.scan(decode, cache, jnp.arange(DECODE, dtype=jnp.int32))
        f32 = lambda t: jax.tree.map(lambda x: x.astype(jnp.float32), t)
        return dict(loss=loss, grads=f32(grads), params=p2, gnorm=gnorm, prefill=logits,
                    prefill_cache=f32(cache), dec=dec, dec_cache=f32(dec_cache))

    o = AdamWState(mu=put(inp["mu"]), nu=put(inp["nu"]), step=jnp.int32(STEP))
    res = jax.jit(outs)(put(inp["params"]), o, inp["toks"], inp["labels"])
    out[name] = jax.tree.map(np.asarray, res)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def port_results(name: str, inp: dict, mesh) -> dict:
    """One case on this rank: every result gathered to whole numpy arrays."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import gather_leaf
    from repro_torch.models import from_reference
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWState, tree_map
    from repro_torch.train import steps as S

    cfg = make_cfg(registry, name)
    p = from_reference(T.init_lm(cfg, device="cpu", mesh=mesh), inp["params"]).params
    toks, labels = torch.tensor(inp["toks"]), torch.tensor(inp["labels"])
    cspecs = T.cache_specs(cfg, mesh, toks.shape[0])

    def whole_cache(c):  # a copy: a cache no axis splits comes back as it is
        return {k: np.array(gather_leaf(v, cspecs[k], mesh).float()) for k, v in c.items()}

    def host(tree):
        return tree_map(lambda t: t.float().numpy(), tree)

    logits, cache = T.lm_prefill(p, toks[:, :PROMPT], cfg, mesh)
    want = _cache_len(cfg)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, want - v.shape[2]))
             for k, v in cache.items()}
    pre_cache, dec = whole_cache(cache), []
    for i in range(DECODE):
        lg, cache = T.lm_decode_step(p, toks[:, PROMPT + i], cache, PROMPT + i, cfg, mesh)
        dec.append(lg.numpy())
    loss, grads = S.lm_loss_and_grad(p, toks, labels, cfg, mesh)
    out = dict(loss=float(loss), grads=host(T.gather_params(grads, cfg, mesh)),
               prefill=logits.numpy(), prefill_cache=pre_cache, dec=np.stack(dec),
               dec_cache=whole_cache(cache))

    def local(tree):
        return tree_map(lambda a: torch.tensor(a), T.shard_params(tree, cfg, mesh))

    opt = AdamWState(mu=local(inp["mu"]), nu=local(inp["nu"]),
                     step=torch.tensor(STEP, dtype=torch.int32))
    p, _, metrics = S.lm_train_step(p, opt, toks, labels, cfg, mesh)
    out.update(params=host(T.gather_params(p, cfg, mesh)), gnorm=float(metrics["gnorm"]),
               step_loss=float(metrics["loss"]))
    return out


def checkpoint_work(mesh, workdir: str, ref_ckpt: str) -> dict:
    """On a 2×2 group: ``launch.train.run`` of ``CKPT_ARCH`` for
    ``CKPT_STEPS`` steps saving its last step (the state it saves also
    gathered by ``gather_params`` as the save is called, and the largest
    tensor any all-gather made during the save, with pieces of at most one
    layer's slice of the largest stacked weight), and the reference's 1×1
    checkpoint restored into this mesh's training state, gathered."""
    import types

    import repro_torch.checkpoint as ckpt
    from repro_torch.checkpoint import checkpoint as ckpt_module
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_map

    cfg = make_cfg(registry, CKPT_ARCH)

    def whole(tree):
        return tree_map(lambda t: t.numpy(), T.gather_params(tree, cfg, mesh))

    saved, gathered = {}, []
    save, all_gather = ckpt.save_checkpoint, mesh.all_gather

    def recording_gather(x, axes):
        out = all_gather(x, axes)
        gathered.append(out.numel() * out.element_size())
        return out

    def recording_save(ckpt_dir, step, tree, **kw):
        saved.update(p=whole(tree["p"]), mu=whole(tree["o"].mu), nu=whole(tree["o"].nu),
                     step=int(tree["o"].step))
        gathered.clear()
        mesh.all_gather = recording_gather
        piece = ckpt_module.SAVE_PIECE_BYTES
        ckpt_module.SAVE_PIECE_BYTES = max(a[0].nbytes for a in saved["p"]["layers"].values())
        try:
            save(ckpt_dir, step, tree, **kw)
        finally:
            mesh.all_gather = all_gather
            ckpt_module.SAVE_PIECE_BYTES = piece
        saved["largest_gather_bytes"] = max(gathered)

    args = types.SimpleNamespace(arch=CKPT_ARCH, steps=CKPT_STEPS, seed=0,
                                 ckpt_dir=os.path.join(workdir, "ckpt_2x2"),
                                 ckpt_every=CKPT_STEPS, fault_at=None, device="cpu")
    ckpt.save_checkpoint = recording_save
    try:
        train.run(args, mesh)
    finally:
        ckpt.save_checkpoint = save
    params, opt, _ = train.build_training(CKPT_ARCH, mesh, device="cpu")
    specs = train.state_specs(CKPT_ARCH, mesh)
    state = ckpt.restore_checkpoint(ref_ckpt, REF_CKPT_STEP, {"p": params, "o": opt},
                                    mesh=mesh, specs=specs)
    opt = train._load_state(params, opt, state)
    return {"restored": {"p": whole(params), "mu": whole(opt.mu), "nu": whole(opt.nu),
                         "step": int(opt.step)},
            "saved": saved,
            "local_shapes": {k: tuple(v.shape) for k, v in params["layers"].items()}}


_RANKS = r"""
import sys
sys.path.insert(0, "tests")
from test_torch_lm_sharded import checkpoint_work, port_results
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh(INPUTS["shape"], ("data", "model"), device="cpu")
for name, inp in INPUTS["cases"].items():
    OUT[name] = port_results(name, inp, mesh)
if INPUTS["ckpt"]:
    OUT["checkpoint"] = checkpoint_work(mesh, *INPUTS["ckpt"])
"""


def _write_reference_checkpoint(path: Path, inp: dict) -> None:
    """The reference's 1×1 training state of ``CKPT_ARCH`` at step
    ``REF_CKPT_STEP``, saved by ``repro.checkpoint``."""
    from repro.checkpoint import save_checkpoint
    from repro.optim.adamw import AdamWState

    save_checkpoint(str(path), REF_CKPT_STEP, {"p": inp["params"], "o": AdamWState(
        mu=inp["mu"], nu=inp["nu"], step=np.int32(REF_CKPT_STEP))}, async_save=False)


@pytest.fixture(scope="module", autouse=True)
def _runs(tmp_path_factory):
    """The reference subprocess and the three rank groups, started once
    when the module's first test starts; whatever still runs at the
    module's end is killed."""
    tmp = tmp_path_factory.mktemp("lm_sharded")
    inputs = make_inputs()
    qwen = {k: inputs[CKPT_ARCH][k] for k in ("params", "mu", "nu")}
    _write_reference_checkpoint(tmp / "ckpt_ref", qwen)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    refs, groups = {}, {}
    try:
        for m, shape in MESHES.items():
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                       XLA_FLAGS=f"--xla_force_host_platform_device_count={np.prod(shape)}")
            log = open(tmp / f"reference_{m}.log", "w")
            refs[m] = (subprocess.Popen(
                [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.pkl"),
                 str(tmp / f"reference_{m}.pkl"), m], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log)
        for m, shape in MESHES.items():
            ckpt = (str(tmp / m), str(tmp / "ckpt_ref")) if m == "2x2" else None
            cases = {c: inputs[c] for c in mesh_cases(m)}
            groups[m] = start_ranks(_RANKS, int(np.prod(shape)),
                                    dict(shape=shape, cases=cases, ckpt=ckpt), tmp / m)
        yield tmp, inputs, refs, groups
    finally:
        procs = list(refs.values()) + [q for _, ps in groups.values() for q in ps]
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


@pytest.fixture(scope="module")
def results(_runs):
    """(inputs, reference results by (mesh, case), {mesh: every rank's OUT}, tmp)."""
    tmp, inputs, refs, groups = _runs
    ranks = {m: join_ranks(h, timeout=300) for m, h in groups.items()}
    ref = {}
    for m, (p, _) in refs.items():
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        assert p.returncode == 0, (tmp / f"reference_{m}.log").read_text()[-4000:]
        with open(tmp / f"reference_{m}.pkl", "rb") as f:
            ref.update({(m, c): v for c, v in pickle.load(f).items()})
    return inputs, ref, ranks, tmp


CASES = [(m, c) for m in MESHES for c in mesh_cases(m)]
IDS = [f"{m}-{c}" for m, c in CASES]


def _dtype(case):
    return "bfloat16" if case.endswith("bf16") else "float32"


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)])
    return out


def _assert_tree(got, want, rel, floor=0.0):
    """Leaf by leaf, same names and shapes, each within ``rel`` of the larger
    of its own largest entry and ``floor`` of the tree's largest."""
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    top = max(float(np.max(np.abs(a), initial=0)) for _, a in w)
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        err = float(np.max(np.abs(a.astype(np.float64) - b), initial=0))
        scale = max(float(np.max(np.abs(b), initial=0)), floor * top)
        assert err <= rel * scale, (k, err, rel, scale)


def _each_rank(results, mesh, case):
    ref = results[1][(mesh, case)]
    for rank, out in enumerate(results[2][mesh]):
        yield rank, out[case], ref


@pytest.mark.parametrize("mesh,case", CASES, ids=IDS)
def test_loss_and_every_gradient(results, mesh, case):
    dt = _dtype(case)
    losses = set()
    for rank, got, ref in _each_rank(results, mesh, case):
        assert abs(got["loss"] - float(ref["loss"])) <= LOSS_REL[dt] * abs(float(ref["loss"])), \
            (rank, got["loss"], float(ref["loss"]))
        _assert_tree(got["grads"], ref["grads"], REL[dt], floor=1e-3)
        losses.add(got["loss"])
    assert len(losses) == 1, losses


@pytest.mark.parametrize("mesh,case", CASES, ids=IDS)
def test_train_step_params_and_gnorm(results, mesh, case):
    dt = _dtype(case)
    for rank, got, ref in _each_rank(results, mesh, case):
        gnorm = float(ref["gnorm"])
        assert abs(got["gnorm"] - gnorm) <= REL[dt] * gnorm, (rank, got["gnorm"], gnorm)
        assert abs(got["step_loss"] - got["loss"]) <= 1e-6 * abs(got["loss"])
        _assert_tree(got["params"], ref["params"], REL[dt])


@pytest.mark.parametrize("mesh,case", CASES, ids=IDS)
def test_prefill_logits_and_cache(results, mesh, case):
    dt = _dtype(case)
    first = None
    for rank, got, ref in _each_rank(results, mesh, case):
        assert_rel_close(got["prefill"], ref["prefill"], REL[dt])
        for k in ("k", "v"):
            assert_rel_close(got["prefill_cache"][k], ref["prefill_cache"][k], REL[dt])
        first = got["prefill"] if first is None else first
        np.testing.assert_array_equal(got["prefill"], first)  # the same on every rank


@pytest.mark.parametrize("mesh,case", CASES, ids=IDS)
def test_decode_steps(results, mesh, case):
    dt = _dtype(case)
    first = None
    for rank, got, ref in _each_rank(results, mesh, case):
        for i in range(DECODE):
            assert_rel_close(got["dec"][i], ref["dec"][i], REL[dt])
        for k in ("k", "v"):
            assert_rel_close(got["dec_cache"][k], ref["dec_cache"][k], REL[dt])
        first = got["dec"] if first is None else first
        np.testing.assert_array_equal(got["dec"], first)


def _port_state(ckpt_dir: Path, step: int) -> dict:
    """A 1×1 port training state of ``CKPT_ARCH`` restored from a checkpoint."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_map

    params, opt, _ = train.build_training(CKPT_ARCH, device="cpu")
    opt = train._load_state(params, opt, restore_checkpoint(
        str(ckpt_dir), step, {"p": params, "o": opt}))
    host = lambda t: tree_map(lambda x: x.detach().numpy(), t)  # noqa: E731
    return {"p": host(params), "mu": host(opt.mu), "nu": host(opt.nu), "step": int(opt.step)}


def _reference_state(ckpt_dir: Path, step: int) -> dict:
    import jax

    from repro.checkpoint import restore_checkpoint
    from repro.configs import registry as ref_registry
    from repro.models import transformer as RT
    from repro.optim.adamw import adamw_init

    cfg = ref_registry.get_config(CKPT_ARCH, smoke=True)
    params = jax.eval_shape(lambda k: RT.init_lm(k, cfg), jax.random.key(0))
    st = restore_checkpoint(str(ckpt_dir), step, {"p": params, "o": adamw_init(params)})
    return {"p": st["p"], "mu": st["o"].mu, "nu": st["o"].nu, "step": int(st["o"].step)}


def _assert_same_state(got: dict, want: dict):
    assert got["step"] == want["step"]
    for part in ("p", "mu", "nu"):
        g, w = _leaves(got[part]), _leaves(want[part])
        assert [k for k, _ in g] == [k for k, _ in w], part
        for (k, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{part}.{k}")


def test_checkpoint_of_a_2x2_run_restores_in_one_rank_and_in_the_reference(results):
    """A 2×2 ``launch.train.run`` saved whole arrays: restored into a 1×1
    port state and into the reference's, they are the state every 2×2
    rank held (its blocks gathered by ``gather_params``), value for value.
    The save gathered a piece at a time: with pieces of at most one layer's
    slice of the largest stacked weight, no all-gather made a larger
    tensor (the 512 × 64 embedding, four times that, went in four)."""
    tmp = results[3]
    ckpt = tmp / "2x2" / "ckpt_2x2"
    port = _port_state(ckpt, CKPT_STEPS)
    assert port["step"] == CKPT_STEPS
    _assert_same_state(_reference_state(ckpt, CKPT_STEPS), port)
    layers = results[0][CKPT_ARCH]["params"]["layers"]
    one_layer = max(a[0].nbytes for a in layers.values())
    for out in results[2]["2x2"]:
        saved = out["checkpoint"]["saved"]
        _assert_same_state(port, saved)
        assert 0 < saved["largest_gather_bytes"] <= one_layer, \
            (saved["largest_gather_bytes"], one_layer)
    # the ranks held blocks: qwen2's smoke wq [2, 64, 4 heads x 16] split over model = 2
    assert results[2]["2x2"][0]["checkpoint"]["local_shapes"]["wq"] == (2, 64, 32)


def test_reference_checkpoint_restores_into_a_2x2_run(results):
    """The reference's 1×1 checkpoint restored on a 2×2 mesh: each rank's
    blocks gather back to the saved arrays, on every rank."""
    inputs = results[0][CKPT_ARCH]
    want = {"p": inputs["params"], "mu": inputs["mu"], "nu": inputs["nu"], "step": REF_CKPT_STEP}
    for out in results[2]["2x2"]:
        _assert_same_state(out["checkpoint"]["restored"], want)
