"""The port's MoE layer (``repro_torch.models.moe``) and the transformer's
``moe`` and ``dense_moe`` structures held against the reference's
(``repro.models.moe``, ``repro.models.transformer``).

The local layer runs on seeded numpy inputs (T 64-128, d 16, f 32, E 8)
through both packages; the LMs are the reference's ``init_lm`` trees (2-4
layers at d 64) carried into the port by ``convert.lm_from_numpy``.  The
expert-parallel paths run the reference once, in a subprocess with 8
forced host devices on a (4, 2) and a (1, 1) mesh, which saves every
output and gradient to an npz; the port runs them on a group-less
``Mesh((4, 2))`` here, and on two gloo ranks in a second subprocess
(no JAX) on (1, 2) and (2, 1) meshes.

Tolerances: positions, ``keep`` masks and selected experts exactly; f32
outputs and aux losses rtol 1e-5 / atol 1e-6 (a whole LM's logits atol
1e-5, as ``tests/test_torch_lm.py`` holds them); gradients rtol 1e-4 /
atol 1e-6 x the largest magnitude of the whole gradient; bf16 compute
outputs atol 0.05 x their largest magnitude
(``tests/test_torch_lm.py::test_bf16_compute``'s 0.03 at a largest logit
of 0.6);
the int8 gather's outputs rtol 1e-5 / atol 1e-5 (a weight an int8 unit
from a rounding tie would move by a scale, ~1e-3 of it: none here) and
its gradients as the others, the gathered weights rtol 1e-6 (the jitted
reference's scales may round an ulp apart); two gloo ranks against one
process atol 1e-6.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
from repro import compat
from repro.configs.base import LMConfig as JLMConfig
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs.base import LMConfig
from repro_torch.convert import lm_from_numpy
from repro_torch.core.sharded_index import Mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import Axes
from repro_torch.tree import flatten_with_names, leaves

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
T, D, FF, E = 128, 16, 32, 8


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed=0, t=T, shared=True, dtype=np.float32):
    """Seeded numpy layer parameters (the reference's distributions), a
    token batch and an output cotangent."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(dtype)

    p = {"router": w(D, E).astype(np.float32), "w_gate": w(E, D, FF),
         "w_up": w(E, D, FF), "w_down": w(E, FF, D)}
    if shared:
        p["shared"] = {"w_gate": w(D, FF), "w_up": w(D, FF),
                       "w_down": w(FF, D)}
    x = rng.normal(size=(t, D)).astype(np.float32)
    ct = rng.normal(size=(t, D)).astype(np.float32)
    return p, x, ct


def _torch_tree(tree, grad=True, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype).requires_grad_(grad)


def _grads_close(got, want, rtol=1e-4, atol_frac=1e-6):
    """Two lists of (name, gradient) in one order, leaf by leaf."""
    top = max(float(np.abs(w).max()) for _, w in want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * top,
                                   err_msg=name)


def _port_value_and_grads(fn, p, x, ct, aux_weight=0.1):
    """(out, aux, [(name, gradient)]) of sum(out * ct) + w * aux over the
    parameters and x."""
    out, aux = fn(p, x)
    loss = torch.sum(out.float() * torch.from_numpy(ct)) + aux_weight * aux
    named = flatten_with_names(p) + [("x", x)]
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return out, aux, [(n, _np(g)) for (n, _), g in zip(named, grads)]


def _ref_named(tree):
    return [("/".join(str(k.key) for k in path), np.asarray(v, np.float32))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# the local layer
# ---------------------------------------------------------------------------


def test_position_in_expert_equals_the_reference():
    ids = np.array([2, 0, 2, 1, 0, 2], np.int32)
    got = tmoe._position_in_expert(torch.from_numpy(ids), 3)
    assert got.tolist() == [0, 0, 1, 0, 1, 2]
    rng = np.random.default_rng(7)
    for m, n in ((1000, 8), (257, 33)):
        ids = rng.integers(0, n, m).astype(np.int32)
        np.testing.assert_array_equal(
            tmoe._position_in_expert(torch.from_numpy(ids), n).numpy(),
            np.asarray(jmoe._position_in_expert(jnp.asarray(ids), n)))


def _jroute(router, x, top_k, cap, n_experts=E):
    """The reference's routing pieces: (sel, keep)."""
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ router.astype(jnp.float32), axis=-1)
    _, sel = jax.lax.top_k(probs, top_k)
    pos = jmoe._position_in_expert(sel.reshape(-1).astype(jnp.int32),
                                   n_experts)
    return sel, pos < cap


@functools.lru_cache(maxsize=None)
def _jlocal(top_k, cf, shared):
    """The reference's moe_fwd with its gradients and routing, jitted."""
    def fn(p, x, ct):
        def loss(p_, x_):
            o, a = jmoe.moe_fwd(p_, x_, n_experts=E, top_k=top_k,
                                capacity_factor=cf)
            return jnp.sum(o * ct) + 0.1 * a, (o, a)
        (_, (o, a)), g = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(p, x)
        cap = int(max(top_k * cf * x.shape[0] / E, 4))
        return o, a, g, _jroute(p["router"], x, top_k, cap)
    return jax.jit(fn)


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_moe_fwd_matches_reference(top_k, shared, cf):
    p, x, ct = _inputs(top_k, shared=shared)
    jo, ja, (jgp, jgx), (jsel, jkeep) = _jlocal(top_k, cf, shared)(p, x, ct)
    tp, tx = _torch_tree(p), torch.from_numpy(x).requires_grad_()
    out, aux, grads = _port_value_and_grads(functools.partial(
        tmoe.moe_fwd, n_experts=E, top_k=top_k, capacity_factor=cf),
        tp, tx, ct)
    np.testing.assert_allclose(_np(out), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ja), **TOL)
    _grads_close(grads, _ref_named(jgp) + [("x", np.asarray(jgx))])
    # the routing: experts and keep masks exactly
    cap = int(max(top_k * cf * T / E, 4))
    _, _, sel = tmoe._route(torch.from_numpy(x), torch.from_numpy(
        p["router"]), top_k)
    keep = tmoe._position_in_expert(sel.reshape(-1), E) < cap
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if cf < 8.0 and top_k < 8:
        assert not keep.all()                 # capacity 16 or 32 drops


def test_moe_fwd_bf16():
    """bf16 expert weights and tokens, the router rounded to bf16 as the
    transformer's ``_cast`` rounds it, then upcast for the logits."""
    p, x, _ = _inputs(3, dtype=np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, jaux = jax.jit(functools.partial(
        jmoe.moe_fwd, n_experts=E, top_k=2, capacity_factor=1.25))(jp, jx)
    tp = _torch_tree(p, False, torch.bfloat16)
    out, aux = tmoe.moe_fwd(tp, torch.from_numpy(x).to(torch.bfloat16),
                            n_experts=E, top_k=2, capacity_factor=1.25)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(out), want,
                               atol=0.05 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    cap = int(max(2 * 1.25 * T / E, 4))
    jsel, jkeep = _jroute(jp["router"], jx, 2, cap)
    _, _, sel = tmoe._route(torch.from_numpy(x).to(torch.bfloat16),
                            tp["router"], 2)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    keep = tmoe._position_in_expert(sel.reshape(-1), E) < cap
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_ties_go_to_the_lower_expert():
    """A router whose columns come in equal pairs (0 = 5, 2 = 3, 4 = 7):
    equal probabilities, and the reference's top-k takes the lower id."""
    p, x, ct = _inputs(5, shared=False)
    for a, b in ((0, 5), (2, 3), (4, 7)):
        p["router"][:, b] = p["router"][:, a]
    jsel, _ = _jroute(jnp.asarray(p["router"]), jnp.asarray(x), 8, T)
    _, _, sel = tmoe._route(torch.from_numpy(x),
                            torch.from_numpy(p["router"]), 8)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    first = {a: b for a, b in ((0, 5), (2, 3), (4, 7))}
    s = sel.numpy()
    for a, b in first.items():         # a is always ranked just before b
        ia, ib = (s == a).argmax(1), (s == b).argmax(1)
        assert (ib == ia + 1).all()
    jo, ja, _, _ = _jlocal(2, 1.25, False)(p, x, ct)
    out, aux = tmoe.moe_fwd(_torch_tree(p, False), torch.from_numpy(x),
                            n_experts=E, top_k=2, capacity_factor=1.25)
    np.testing.assert_allclose(_np(out), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(aux), float(ja), **TOL)


def test_drop_slot_never_reaches_the_output():
    """Capacity 4 of 128 tokens at top-1: most tokens drop, their rows are
    0 and their gradient is 0 (no shared expert)."""
    p, x, ct = _inputs(6, shared=False)
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tmoe.moe_fwd(_torch_tree(p, False), tx, n_experts=E, top_k=1,
                          capacity_factor=0.01)
    _, _, sel = tmoe._route(tx.detach(), torch.from_numpy(p["router"]), 1)
    keep = (tmoe._position_in_expert(sel.reshape(-1), E) < 4).numpy()
    assert keep.sum() <= 4 * E and not keep.all()
    assert (_np(out)[~keep] == 0).all() and (_np(out)[keep] != 0).any()
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)), tx)
    assert (_np(g)[~keep] == 0).all()


# ---------------------------------------------------------------------------
# the transformer's MoE structures
# ---------------------------------------------------------------------------

BASE = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=257, param_dtype="float32", compute_dtype="float32")
LMS = {
    # granite's structure: every layer MoE, top-2, tokens dropped
    "moe": dict(n_layers=2, moe=True, n_experts=8, top_k=2,
                capacity_factor=1.25, remat=False),
    # llama4's: [dense, MoE] groups, top-1, a shared expert, remat, windows
    "dense_moe": dict(n_layers=4, moe=True, moe_every=2, n_experts=8,
                      top_k=1, shared_expert=True, capacity_factor=1.25,
                      remat=True, sliding_window=6, global_every=2),
}


@functools.lru_cache(maxsize=None)
def _lm(name):
    """(reference params, port model, reference cfg, port cfg): the port's
    seeded init as numpy arrays on the reference's tree, carried back by
    ``lm_from_numpy`` (the reference's own init compiles for seconds)."""
    kw = {**BASE, **LMS[name]}
    jc, tc = JLMConfig(name="t", **kw), LMConfig(name="t", **kw)
    own = ttr.init_lm(torch.Generator().manual_seed(0), tc, "cpu")
    tree = jax.tree.map(lambda a: a.detach().numpy(), ttr._tree(own))
    assert _shapes(tree) == _shapes(jax.eval_shape(functools.partial(
        jtr.init_lm, cfg=jc), jax.random.key(0)))
    return tree, lm_from_numpy(tree, tc, "cpu"), jc, tc


def _shapes(tree):
    return [("/".join(str(k.key) for k in path), tuple(v.shape),
             np.dtype(v.dtype).name)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _lm_batch(b=2, s=16, seed=1):
    tok = np.random.default_rng(seed).integers(0, 257, (b, s + 1)).astype(
        np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("name", list(LMS))
def test_lm_forward_loss_and_gradients(name):
    jp, model, jc, tc = _lm(name)
    assert ttr.structure(tc) == name
    batch = _lm_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def fn(p, b):
        logits, aux = jtr.forward(p, b["tokens"], jc)
        (loss, m), g = jax.value_and_grad(
            lambda p_: jtr.loss_fn(p_, b, jc), has_aux=True)(p)
        return logits, aux, loss, m, g
    jlogits, jaux, jloss, jm, jg = jax.jit(fn)(jp, batch)
    logits, aux = ttr.forward(model, tb["tokens"], tc)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    assert float(aux) > 0.5                   # the layers' aux summed
    loss, metrics = ttr.loss_fn(model, tb, tc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               **TOL)
    grads = torch.autograd.grad(loss, leaves(model))
    _grads_close([(n, _np(g)) for (n, _), g in
                  zip(flatten_with_names(model), grads)], _ref_named(jg))
    # the aux term's gradient reaches the routers (through remat too)
    aux_g = torch.autograd.grad(ttr.forward_hidden(model, tb["tokens"],
                                                   tc)[1], leaves(model),
                                allow_unused=True)
    named = dict(zip([n for n, _ in flatten_with_names(model)], aux_g))
    router = [n for n in named if n.endswith("moe/router")]
    assert router and all(float(named[n].abs().max()) > 0 for n in router)


@pytest.mark.parametrize("name", list(LMS))
def test_lm_prefill_then_decode(name):
    """The reference's prefill (``last_only``) of 12 tokens and 4 decode
    steps against the port's, logits and cache (``dense_moe``'s layer
    order included)."""
    jp, model, jc, tc = _lm(name)
    tok = np.random.default_rng(5).integers(0, 257, (2, 16)).astype(np.int32)
    jstep = jax.jit(functools.partial(jtr.decode_step, cfg=jc),
                    static_argnames="last_only")
    jcache = jtr.init_cache(jc, 2, 16, jnp.float32)
    tcache = ttr.init_cache(tc, 2, 16, torch.float32, "cpu")
    with torch.no_grad():
        wl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, :12]),
                           jnp.zeros((), jnp.int32), last_only=True)
        gl, gc = ttr.decode_step(model, tcache, torch.from_numpy(tok[:, :12]),
                                 0, tc, last_only=True)
        assert gc is tcache
        np.testing.assert_allclose(_np(gl), np.asarray(wl), **MODEL_TOL)
        for t in range(12, 16):
            wl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
            gl, gc = ttr.decode_step(model, gc,
                                     torch.from_numpy(tok[:, t:t + 1]), t,
                                     tc)
            np.testing.assert_allclose(_np(gl), np.asarray(wl), **MODEL_TOL)
    np.testing.assert_allclose(_np(gc.k), np.asarray(jcache.k), **MODEL_TOL)
    np.testing.assert_allclose(_np(gc.v), np.asarray(jcache.v), **MODEL_TOL)


@pytest.mark.parametrize("name", list(LMS))
def test_lm_names_and_shapes_equal_the_reference(name):
    _, model, jc, tc = _lm(name)
    want = _shapes(jax.eval_shape(functools.partial(jtr.init_lm, cfg=jc),
                                  jax.random.key(0)))
    for m in (model, ttr.init_lm(None, tc, "meta")):
        assert [(n, tuple(x.shape), str(x.dtype)[6:]) for n, x in
                flatten_with_names(m)] == want
    own = ttr.init_lm(torch.Generator().manual_seed(0), tc, "cpu")
    router = dict(flatten_with_names(own))[
        "layers/moe/router" if name == "moe" else "layers/moe/moe/router"]
    assert router.dtype == torch.float32
    assert abs(float(router.std()) * np.sqrt(64) - 1) < 0.1


def test_at_a_one_cell_mesh_the_block_runs_the_sharded_path():
    """An ``axes`` with a (1, 1) mesh routes the MoE blocks through
    ``moe_fwd_sharded`` (``moe_fwd_a2a`` under ``moe_a2a``), which at one
    cell computes the local layer's function."""
    _, model, _, tc = _lm("dense_moe")
    tok = torch.from_numpy(_lm_batch()["tokens"])
    want = ttr.forward(model, tok, tc)[0]
    mesh = Mesh((1, 1), device="cpu")
    for cfg in (tc, LMConfig(**{**tc.__dict__, "moe_a2a": True})):
        got = ttr.forward(model, tok, cfg, Axes(("data",), "model", mesh))[0]
        np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the expert-parallel paths
# ---------------------------------------------------------------------------

# (tag, path, keyword arguments, capacity factor, gradients)
CASES = [
    ("sh_ample", "sharded", {}, 8.0, False),
    ("sh_drop", "sharded", {}, 1.25, True),
    ("fs_ample", "sharded", {"fsdp": True}, 8.0, False),
    ("fs_drop", "sharded", {"fsdp": True}, 1.25, False),
    ("gq_ample", "sharded", {"fsdp": True, "gather_quant": True}, 8.0, False),
    ("gq_drop", "sharded", {"fsdp": True, "gather_quant": True}, 1.25, True),
    ("a2a_ample", "a2a", {}, 8.0, False),
    ("a2a_drop", "a2a", {}, 1.25, True),
]
ONE_CELL = [("one_ample", "sharded", {}, 8.0, False),
            ("one_drop", "sharded", {}, 1.25, False)]

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.models import moe
from repro.models.layers import Axes
E = {E}
z = np.load(sys.argv[1])
params = {{k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up",
                                          "w_down")}}
params["shared"] = {{k: jnp.asarray(z["shared_" + k])
                    for k in ("w_gate", "w_up", "w_down")}}
x, ct = jnp.asarray(z["x"]), jnp.asarray(z["ct"])
out = {{}}
for shape, cases in (((4, 2), {CASES}), ((1, 1), {ONE_CELL})):
    mesh = compat.make_mesh(shape, ("data", "model"))
    axes = Axes(dp=("data",), tp="model", mesh=mesh)

    def run(p, xx):
        res = {{}}
        for tag, path, kw, cf, grad in cases:
            if path == "sharded":
                def fn(p_, x_, kw=kw, cf=cf):
                    return moe.moe_fwd_sharded(p_, x_, n_experts=E, top_k=2,
                                               capacity_factor=cf,
                                               axes=axes, **kw)
            else:
                def fn(p_, x_, kw=kw, cf=cf):
                    return moe.moe_fwd_a2a(p_, x_, n_experts=E,
                                           capacity_factor=cf, axes=axes,
                                           **kw)
            o, a = fn(p, xx)
            res[tag + "/out"], res[tag + "/aux"] = o, a
            if grad:
                g = jax.grad(lambda p_, x_: jnp.sum(fn(p_, x_)[0] * ct)
                             + 0.1 * fn(p_, x_)[1], argnums=(0, 1))(p, xx)
                for path_, v in jax.tree_util.tree_flatten_with_path(g[0])[0]:
                    res[tag + "/g/" + "/".join(k.key for k in path_)] = v
                res[tag + "/g/x"] = g[1]
        return res

    with mesh:
        res = jax.jit(run)(params, x)
    out.update({{k: np.asarray(v) for k, v in res.items()}})
np.savez(sys.argv[2], **out)
"""


def _layer_npz(path, p, x, ct):
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({"shared_" + k: v for k, v in p["shared"].items()})
    np.savez(path, x=x, ct=ct, **flat)


@pytest.fixture(scope="module")
def sharded_ref(tmp_path_factory):
    """The reference's expert-parallel outputs and gradients, computed
    once in a subprocess with 8 host devices."""
    d = tmp_path_factory.mktemp("moe")
    p, x, ct = _inputs(11)
    _layer_npz(d / "in.npz", p, x, ct)
    code = REFERENCE.format(E=E, CASES=CASES, ONE_CELL=ONE_CELL)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(d / "in.npz"),
                          str(d / "ref.npz")], capture_output=True,
                         text=True, timeout=600, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    with np.load(d / "ref.npz") as z:
        return (p, x, ct), {k: z[k] for k in z.files}


def _port_case(p, x, ct, path, kw, cf, mesh, grad=True):
    axes = Axes(("data",), "model", mesh)
    if path == "sharded":
        fn = functools.partial(tmoe.moe_fwd_sharded, n_experts=E, top_k=2,
                               capacity_factor=cf, axes=axes, **kw)
    elif path == "a2a":
        fn = functools.partial(tmoe.moe_fwd_a2a, n_experts=E,
                               capacity_factor=cf, axes=axes, **kw)
    else:
        fn = functools.partial(tmoe.moe_fwd, n_experts=E, top_k=2,
                               capacity_factor=cf)
    tp, tx = _torch_tree(p), torch.from_numpy(x).requires_grad_()
    if not grad:
        with torch.no_grad():
            out, aux = fn(tp, tx)
        return out, aux, None
    return _port_value_and_grads(fn, tp, tx, ct)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_expert_parallel_paths_match_the_reference(sharded_ref, case):
    (p, x, ct), ref = sharded_ref
    tag, path, kw, cf, grad = case
    out, aux, grads = _port_case(p, x, ct, path, kw, cf,
                                 Mesh((4, 2), device="cpu"), grad)
    tol = dict(rtol=1e-5, atol=1e-5) if kw.get("gather_quant") else TOL
    np.testing.assert_allclose(_np(out), ref[tag + "/out"], **tol)
    np.testing.assert_allclose(float(aux.detach()), float(ref[tag + "/aux"]),
                               **TOL)
    if grad:
        _grads_close(grads, [(n, ref[f"{tag}/g/{n}"]) for n, _ in grads])
    if cf < 8.0:        # the case drops tokens: unlike the ample one
        ample = ref[tag.replace("drop", "ample") + "/out"] \
            if tag.endswith("drop") else None
        assert ample is None or not np.allclose(ample, _np(out), atol=1e-3)


def test_one_cell_reference_equals_the_local_layer(sharded_ref):
    """At (1, 1) the reference's ``moe_fwd_sharded`` computes the port's
    ``moe_fwd`` (the aux of the one cell is the layer's)."""
    (p, x, ct), ref = sharded_ref
    for tag, _, _, cf, _ in ONE_CELL:
        out, aux, _ = _port_case(p, x, ct, "local", {}, cf, None, False)
        np.testing.assert_allclose(_np(out), ref[tag + "/out"], **TOL)
        np.testing.assert_allclose(float(aux), float(ref[tag + "/aux"]),
                                   **TOL)


def test_quantized_gather_is_the_reference_custom_vjp():
    """``make_quantized_all_gather`` without a group: each dp shard
    quantized on its own (per-(expert, column) int8 scales), and the
    backward the straight-through transpose, as the reference's
    ``custom_vjp`` on a one-device mesh."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 12, 6)).astype(np.float32)
    ct = rng.normal(size=(4, 12, 6)).astype(np.float32)
    qag = tmoe.make_quantized_all_gather(("data",), 1)
    shards = [torch.from_numpy(s).requires_grad_()
              for s in np.split(w, 3, axis=1)]
    got = qag(shards)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    spec = jax.sharding.PartitionSpec()
    one = jax.jit(compat.shard_map(
        jmoe.make_quantized_all_gather(("data",), axis=1), mesh=mesh,
        in_specs=spec, out_specs=spec, check_vma=False))
    want = [np.asarray(one(jnp.asarray(s))) for s in np.split(w, 3, axis=1)]
    # the jitted reference's scales may round 1 ulp apart (its max / 127)
    np.testing.assert_allclose(_np(got), np.concatenate(want, axis=1),
                               rtol=1e-6, atol=0)
    assert 0 < np.abs(_np(got) - w).max() < np.abs(w).max() / 127
    grads = torch.autograd.grad(got, shards, torch.from_numpy(ct))
    for g, c in zip(grads, np.split(ct, 3, axis=1)):
        np.testing.assert_array_equal(_np(g), c)


RANKS = """
import os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.core.sharded_index import Mesh
from repro_torch.models import moe
from repro_torch.models.layers import Axes
from repro_torch.tree import flatten_with_names
E = {E}
CASES = {CASES}


def main(rank, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=2)
    try:
        z = np.load(os.path.join(d, "in.npz"))
        out = {{}}
        for shape in ((1, 2), (2, 1)):
            mesh = Mesh(shape, device="cpu", group=dist.group.WORLD)
            axes = Axes(("data",), "model", mesh)
            for tag, path, kw, cf in CASES:
                p = {{k: torch.from_numpy(z[k]).requires_grad_()
                     for k in ("router", "w_gate", "w_up", "w_down")}}
                p["shared"] = {{k: torch.from_numpy(z["shared_" + k])
                               .requires_grad_()
                               for k in ("w_gate", "w_up", "w_down")}}
                x = torch.from_numpy(z["x"]).requires_grad_()
                if path == "sharded":
                    o, a = moe.moe_fwd_sharded(p, x, n_experts=E, top_k=2,
                                               capacity_factor=cf, axes=axes,
                                               **kw)
                else:
                    o, a = moe.moe_fwd_a2a(p, x, n_experts=E,
                                           capacity_factor=cf, axes=axes,
                                           **kw)
                loss = torch.sum(o * torch.from_numpy(z["ct"])) + 0.1 * a
                named = flatten_with_names(p) + [("x", x)]
                gs = torch.autograd.grad(loss, [t for _, t in named])
                key = f"{{shape[0]}}x{{shape[1]}}/{{tag}}"
                out[key + "/out"] = o.detach().numpy()
                out[key + "/aux"] = a.detach().numpy()
                for (n, _), g in zip(named, gs):
                    out[key + "/g/" + n] = g.numpy()
        np.savez(os.path.join(d, f"rank{{rank}}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(main, args=(sys.argv[1],), nprocs=2, join=True)
"""
RANK_CASES = [("sh", "sharded", {}, 1.25),
              ("fs", "sharded", {"fsdp": True}, 1.25),
              ("gq", "sharded", {"fsdp": True, "gather_quant": True}, 1.25),
              ("a2a", "a2a", {}, 1.25)]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """(1, 2): tp across ranks (the psum, the all-to-alls); (2, 1): dp
    across ranks (the weight gathers and the int8 gather's reduce-scatter
    backward).  Each rank's outputs, aux and gradients equal the
    group-less mesh's of the same shape."""
    p, x, ct = _inputs(12)
    _layer_npz(tmp_path / "in.npz", p, x, ct)
    script = tmp_path / "ranks.py"
    script.write_text(RANKS.format(E=E, CASES=RANK_CASES))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr}"
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for shape in ((1, 2), (2, 1)):
        mesh = Mesh(shape, device="cpu")
        for tag, path, kw, cf in RANK_CASES:
            out, aux, grads = _port_case(p, x, ct, path, kw, cf, mesh)
            key = f"{shape[0]}x{shape[1]}/{tag}"
            for z in ranks:
                np.testing.assert_allclose(z[key + "/out"], _np(out),
                                           rtol=0, atol=1e-6, err_msg=key)
                np.testing.assert_allclose(float(z[key + "/aux"]), float(aux),
                                           rtol=0, atol=1e-6, err_msg=key)
                for n, g in grads:
                    np.testing.assert_allclose(z[f"{key}/g/{n}"], g, rtol=0,
                                               atol=1e-6, err_msg=key + n)


def test_a_group_needs_one_rank_a_cell():
    class OneRank:
        pass
    mesh = Mesh((2, 1), device="cpu")
    mesh.group, mesh.world = OneRank(), 1
    p, x, _ = _inputs(0)
    with pytest.raises(ValueError, match="one rank a cell"):
        tmoe.moe_fwd_sharded(_torch_tree(p, False), torch.from_numpy(x),
                             n_experts=E, top_k=2, capacity_factor=1.25,
                             axes=Axes(("data",), "model", mesh))
