"""The port's training held against the reference's: ``train/`` (the
optimizers, ``grad_compress``, the train state and its steps, the loop and
its watchdog), the checkpointer's async save and preemption handler,
``convert.train_state_from_numpy``, ``launch/steps.py``'s train cells and
``launch/train.py``, and the gradients of the gathers and the bag (faults 7
and 8 of ROADMAP.md queue 3).

Small configurations as ``tests/test_torch_recsys.py`` makes them (tables of
at most 500 rows, 2,000 items, ``row_pad_to`` 8, a batch of 16), with ids
below 0 and past every table, so both packages' gradients follow the
reference's rule: the forward wraps a negative id once and clamps the rest,
and the backward drops every id the forward clamped.  The parameters are
seeded numpy arrays on the reference's trees (its own ``init_mind`` for
MIND), carried into the port through ``convert``.  Loops and
checkpoints use a two-layer regression on a dict of arrays, which each
package compiles or runs in a fraction of a second.

Tolerances: the gather's gradient exactly (sums of small integers); the
bag's rtol 1e-5; one optimizer update rtol 1e-6 / atol 1e-7 over 3 steps;
the models' gradients rtol 1e-4 / atol 1e-6; 3 train steps' losses rtol
1e-4 and parameters atol 1e-5 (AdamW's first steps are close to sign(g),
so the parameters are held loosely and the gradients tightly);
``compressed_psum``'s payload and residuals exactly, its mean rtol 1e-6.
"""
import dataclasses
import functools
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import recsys as jrs
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro.train import train_state as jts
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.convert import recsys_from_numpy, train_state_from_numpy
from repro_torch.core.sharded_index import Mesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import recsys as trs
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train import train_state as tts
from repro_torch.tree import flatten_with_names, leaves

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B = 16
RECSYS = ["mind", "dlrm-mlperf", "autoint", "wide-deep"]


def _smoke(cfg):
    return dataclasses.replace(
        cfg, table_sizes=tuple(min(s, 500) for s in cfg.table_sizes),
        item_vocab=min(cfg.item_vocab, 2000) if cfg.item_vocab else 0,
        row_pad_to=8)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double()
    return np.asarray(x, np.float64)


def _named(tree):
    return {n: _np(x) for n, x in flatten_with_names(tree)}


def _jnamed(tree):
    return {n: _np(x) for n, x in jckpt._flatten_with_names(tree)}


def _close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


def _manifest(ckpt, step):
    with open(os.path.join(ckpt.dir, f"step_{step:010d}",
                           "manifest.json")) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, numpy params) of ``arch``."""
    jc = _smoke(jconfigs.get_arch(arch).config)
    tc = _smoke(tconfigs.get_arch(arch).config)
    if jc.model == "mind":
        params = jax.device_get(jax.jit(functools.partial(
            jrs.init_mind, cfg=jc))(jax.random.key(0)))
    else:
        rng = np.random.default_rng(len(arch))

        def fill(s):
            scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.1
            return (rng.normal(size=s.shape) * scale).astype(np.float32)

        params = jax.tree.map(fill, jax.eval_shape(jsteps._recsys_init(jc)))
    return jc, tc, params


def _batch(cfg, b, seed):
    """Seeded ids, some below 0 and some past every table, and labels."""
    rng = np.random.default_rng(seed)
    if cfg.model == "mind":
        out = {"hist": rng.integers(-5, cfg.item_vocab + 100,
                                    (b, cfg.hist_len)).astype(np.int32),
               "target": rng.integers(-5, cfg.item_vocab + 100,
                                      b).astype(np.int32)}
    else:
        out = {"sparse": rng.integers(-600, 600, (b, cfg.n_sparse)
                                      ).astype(np.int32)}
        if cfg.n_dense:
            out["dense"] = rng.normal(size=(b, cfg.n_dense)
                                      ).astype(np.float32)
    out["labels"] = (rng.uniform(size=b) < 0.5).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jloss(cfg):
    fwd = jsteps._recsys_fwd(cfg)

    def lf(p, b):
        logits = fwd(p, b)
        lab = b["labels"]
        return jnp.mean(jnp.maximum(logits, 0) - logits * lab
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    return lf


# ---------------------------------------------------------------------------
# faults 7 and 8: the gather's and the bag's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["issue", "random"])
def test_take_rows_gradient_drops_the_clamped_ids(case):
    if case == "issue":
        table = np.arange(10, dtype=np.float32).reshape(5, 2)
        ids = np.array([7, -1, 100, -7, 2], np.int32)
    else:
        rng = np.random.default_rng(3)
        table = rng.integers(-4, 5, (23, 6)).astype(np.float32)
        ids = rng.integers(-60, 60, (7, 9)).astype(np.int32)
        ids[0, :4] = [-23, -24, 23, 22]
    wt = (np.arange(ids.size * table.shape[1], dtype=np.float32) + 1
          ).reshape(ids.shape + table.shape[1:])
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(ids)] * wt))(
        jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    rows = trs.take_rows(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  np.asarray(jnp.asarray(table)[ids]))
    (rows * torch.from_numpy(wt)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    if case == "issue":
        expect = np.zeros((5, 2), np.float32)
        expect[4], expect[2] = [3, 4], [9, 10]
        np.testing.assert_array_equal(t.grad.numpy(), expect)


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_gradients_match_jax_grad(weighted):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(37, 24)).astype(np.float32)
    ids = rng.integers(-80, 80, (9, 13)).astype(np.int32)
    ids[0, :5] = [7 + 37, -1, 100, -7 - 37, 2]
    w = rng.uniform(size=ids.shape).astype(np.float32)
    g = rng.normal(size=(9, 24)).astype(np.float32)

    def jloss(t, w_):
        return jnp.sum(jrs.embedding_bag(t, jnp.asarray(ids),
                                         w_ if weighted else None) * g)

    jt, jw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                             jnp.asarray(w))
    t = torch.tensor(table, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = trs.embedding_bag(t, torch.from_numpy(ids), tw if weighted
                            else None)
    assert out.requires_grad
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert tw.grad is None


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_params(rng):
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32)},
                       {"w": rng.normal(size=(2, 4, 6)).astype(np.float32)}]}


OPTS = {
    "adamw f32": lambda m: m.adamw(m.cosine_schedule(0.1, 2, 10),
                                   weight_decay=0.1),
    "adamw bf16": lambda m: m.adamw(m.constant_schedule(1e-2),
                                    state_dtype=(jnp.bfloat16 if m is jopt
                                                 else torch.bfloat16)),
    "adafactor": lambda m: m.adafactor(m.cosine_schedule(0.5, 1, 5),
                                       weight_decay=0.01),
    "sgdm": lambda m: m.sgdm(lambda s: 0.05),
    "sgdm clipped": lambda m: m.sgdm(m.constant_schedule(0.05),
                                     max_grad_norm=0.5),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(len(name))
    params = _opt_params(rng)
    jo, to = OPTS[name](jopt), OPTS[name](topt)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    _close(_named(ts), _jnamed(js))
    for _ in range(3):
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 3
                                    ).astype(np.float32), params)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(jax.tree.map(torch.tensor, g), ts, tp)
        _close(_named(tu), _jnamed(ju), **OPT_TOL)
        _close(_named(ts), _jnamed(js), **OPT_TOL)
        jp = jopt.apply_updates(jp, ju)
        assert topt.apply_updates(tp, tu) is tp
        _close(_named(tp), _jnamed(jp), **OPT_TOL)
    if name == "adamw bf16":
        assert ts.m["b"].dtype == ts.v["b"].dtype == torch.bfloat16
    if name == "adafactor":       # factored for rank >= 2
        assert ts.vr["layers"][1]["w"].shape == (2, 4)
        assert ts.vc["layers"][1]["w"].shape == (2, 6)
        assert ts.vc["b"].shape == (1,)


def test_global_norm_clip_and_cosine_schedule():
    rng = np.random.default_rng(1)
    tree = _opt_params(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.tensor, tree)
    np.testing.assert_allclose(float(topt.global_norm(ttree)),
                               float(jopt.global_norm(jtree)), **OPT_TOL)
    for bound in (1.0, 1e6):
        (jc, jn), (tc, tn) = (jopt.clip_by_global_norm(jtree, bound),
                              topt.clip_by_global_norm(ttree, bound))
        np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
        _close(_named(tc), _jnamed(jc), **OPT_TOL)
    jl, tl = (m.cosine_schedule(1.0, warmup=10, total=110, final_frac=0.1)
              for m in (jopt, topt))
    for step in (0, 5, 10, 60, 110, 200):
        got = tl(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jl(step)), **OPT_TOL)
    got = topt.constant_schedule(3e-4)(7)
    assert got.dtype == torch.float32 and float(got) == float(
        jopt.constant_schedule(3e-4)(7))


def test_compressed_psum_matches_reference_on_one_device():
    rng = np.random.default_rng(2)
    grads = _opt_params(rng)
    res = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), grads)
    jfn = jax.jit(jax.vmap(lambda g, r: jgc.compressed_psum(g, r, "dp", 1),
                           axis_name="dp"))
    tres = tgc.init_residuals(jax.tree.map(torch.tensor, grads))
    for _ in range(2):                # the second step feeds the error back
        jm, jr = jax.device_get(jfn(*(jax.tree.map(lambda x: x[None], t)
                                      for t in (grads, res))))
        tg = jax.tree.map(torch.tensor, grads)
        payload = [tgc.quantize(g, r)[0] for g, r in zip(leaves(tg),
                                                          leaves(tres))]
        tm, tres = tgc.compressed_psum(tg, tres, None, 1)
        for q, g, r in zip(payload, leaves(grads), leaves(res)):
            gf = g + r
            scale = np.float32(np.abs(gf).max() / np.float32(127.0)
                               + np.float32(1e-12))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(
                q.numpy(), np.clip(np.round(gf / scale), -127, 127))
        for (n, got), want in zip(flatten_with_names(tres),
                                  leaves(jax.tree.map(lambda x: x[0], jr))):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
        _close(_named(tm), _named(jax.tree.map(lambda x: x[0], jm)),
               rtol=1e-6, atol=0)
        res = jax.tree.map(lambda x: np.asarray(x[0]), jr)
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape)
                                        ).astype(np.float32), grads)
    with pytest.raises(ValueError, match="one shard"):
        tgc.compressed_psum(tg, tres, None, 2)


# ---------------------------------------------------------------------------
# the models' gradients and train steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jgrad(arch):
    """The reference's jitted (loss, grads) of ``arch``'s BCE."""
    return jax.jit(jax.value_and_grad(_jloss(_model(arch)[0])))


@pytest.mark.parametrize("arch", RECSYS)
def test_model_gradients_match_jax_grad(arch):
    jc, tc, params = _model(arch)
    batch = _batch(jc, B, seed=21)
    jloss, want = _jgrad(arch)(params, _j(batch))
    model = recsys_from_numpy(params, tc, device="cpu")
    loss, _, grads = tts.value_and_grad(tsteps.recsys_loss(tc), model,
                                        _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
    _close(_named(grads), _jnamed(want), **GRAD_TOL)
    # rows that only clamped ids reach take no gradient in either package
    if jc.model != "mind":
        table = _jnamed(want)["tables/0"]
        assert np.abs(table).sum(axis=1).astype(bool).sum() < table.shape[0]


def _train_programs(arch, cell):
    jc, tc, params = _model(arch)
    jprog = jsteps._recsys_train_program(
        dataclasses.replace(jconfigs.get_arch(arch), config=jc), cell,
        jmesh.make_test_mesh((1, 1)), False)
    tprog = tsteps._recsys_train_program(
        dataclasses.replace(tconfigs.get_arch(arch), config=tc), cell,
        Mesh((1, 1), device="cpu"), False)
    return jc, tc, params, jprog, tprog


@pytest.mark.parametrize("arch", ["mind", "dlrm-mlperf"])
def test_train_step_matches_reference(arch):
    cell = dataclasses.replace(
        {c.name: c for c in jconfigs.get_arch(arch).cells}["train_batch"],
        batch=B)
    jc, tc, params, jprog, tprog = _train_programs(arch, cell)
    jstate = jax.device_get(jts.TrainState(
        np.zeros((), np.int32), params,
        jopt.adamw(jopt.constant_schedule(1e-3)).init(params), None))
    tstate = train_state_from_numpy(jstate, tc, device="cpu")
    assert isinstance(tstate.params, trs.MODELS[tc.model])
    jstate = jax.tree.map(jnp.asarray, jstate)
    jstep = jax.jit(jprog.fn)
    # elements whose reference gradient falls, at some step, within the
    # gradient comparison's atol (1e-6 x the leaf's largest magnitude) of
    # 0: there AdamW's g / (|g| + eps) turns that noise into up to a whole
    # step of lr 1e-3 in either direction
    noisy = {}
    for i in range(3):
        batch = _batch(jc, B, seed=30 + i)
        for n, g in _jnamed(_jgrad(arch)(jstate.params, _j(batch))[1]
                            ).items():
            tiny = np.abs(g) <= 1e-6 * np.abs(g).max()
            noisy[f"params/{n}"] = noisy.get(f"params/{n}", False) | tiny
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tprog.fn(tstate, _t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    assert int(tstate.step) == int(jstate.step) == 3
    assert int(tstate.opt_state.step) == 3
    got, want = _named(tstate), _jnamed(jstate)
    assert sorted(got) == sorted(want)
    for name in want:
        err = np.abs(got[name] - want[name])
        if name in noisy:
            assert (err[noisy[name]] <= 2 * 3 * 1e-3).all(), name
            err = err[~noisy[name]]
        assert (err <= 1e-5).all(), (name, err.max())
    # the program's arguments from a generator: a real state and batch
    state, batch = tprog.make_args(torch.Generator().manual_seed(4))
    assert set(batch) == set(tprog.args[1]) and "labels" in batch
    assert [n for n, _ in flatten_with_names(state)] == \
        [n for n, _ in flatten_with_names(tprog.args[0])]


# ---------------------------------------------------------------------------
# the step factories, the loop, checkpoints and preemption on a small
# regression (a dict of arrays, no model)
# ---------------------------------------------------------------------------


def _reg_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(6, 8)) / 3).astype(np.float32),
            "b1": np.zeros((8,), np.float32),
            "w2": (rng.normal(size=(8, 1)) / 3).astype(np.float32)}


def _reg_batches(n, b=8, seed=1, lead=()):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=lead + (b, 6)).astype(np.float32)
        out.append({"x": x, "y": np.sin(x.sum(-1, keepdims=True))
                    .astype(np.float32)})
    return out


def _jreg(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - b["y"]) ** 2), {}


def _treg(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - b["y"]) ** 2), {}


def _states(opt_name="adamw f32"):
    params = _reg_params()
    jo, to = OPTS[opt_name](jopt), OPTS[opt_name](topt)
    jstate = jts.init_train_state(jax.tree.map(jnp.asarray, params), jo)
    tstate = train_state_from_numpy(jax.device_get(jstate), device="cpu")
    return jo, to, jstate, tstate


def test_microbatched_step_matches_reference():
    jo, to, jstate, tstate = _states()
    jstep = jts.make_microbatched_train_step(_jreg, jo, n_micro=2)
    tstep = tts.make_microbatched_train_step(_treg, to, n_micro=2)
    for batch in _reg_batches(3, b=4, lead=(2,)):
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _close(_named(tstate), _jnamed(jstate), rtol=1e-5, atol=1e-7)


def test_watchdog_flags_stragglers():
    seq = [0.1] * 10 + [1.0] + [0.1] * 3
    dogs = [m.Watchdog(factor=3.0, warmup=3) for m in (jloop, tloop)]
    flagged = [[s for s, dt in enumerate(seq) if d.observe(s, dt)]
               for d in dogs]
    assert flagged == [[10], [10]]
    assert dogs[1].events == dogs[0].events
    assert dogs[1].ema == dogs[0].ema and dogs[1].ema < 0.2


def test_loop_resumes_from_either_package(tmp_path, capsys):
    """Six steps straight in each package, checkpoints every two; then each
    package resumes from the other's step-4 checkpoint and runs steps 4 and
    5 on the same batches."""
    batches = _reg_batches(6)
    runs = {}
    for pkg, loop, step_fn, conv in (
            ("ref", jloop, lambda jo, to: jts.make_train_step(_jreg, jo),
             _j),
            ("port", tloop, lambda jo, to: tts.make_train_step(_treg, to),
             _t)):
        jo, to, jstate, tstate = _states()
        cfg = loop.LoopConfig(total_steps=6, ckpt_every=2, log_every=0,
                              ckpt_dir=str(tmp_path / pkg), ckpt_async=True)
        state = jstate if pkg == "ref" else tstate
        state, hist = loop.train(state, step_fn(jo, to),
                                 (conv(b) for b in batches), cfg)
        runs[pkg] = (state, hist)
    np.testing.assert_allclose(runs["port"][1]["loss"],
                               runs["ref"][1]["loss"], rtol=1e-5)
    # the checkpoints: the same steps, leaf names, dtypes and values
    jc, tc = (jckpt.Checkpointer(str(tmp_path / p)) for p in ("ref", "port"))
    assert tc.all_steps() == jc.all_steps() == [2, 4, 6]
    for s in (4, 6):
        jm, tm = (_manifest(c, s) for c in (jc, tc))
        assert [(x["name"], x["shape"], x["dtype"]) for x in tm["leaves"]] \
            == [(x["name"], x["shape"], x["dtype"]) for x in jm["leaves"]]
    names = [x["name"] for x in _manifest(tc, 6)["leaves"]]
    assert names[:2] == ["step", "params/b1"] and "opt_state/m/w1" in names
    for s in (4, 6):
        _close(_named(tckpt.Checkpointer(str(tmp_path / "port")).restore(
            runs["port"][0], step=s)[0]),
               _named(tckpt.Checkpointer(str(tmp_path / "ref")).restore(
                   runs["port"][0], step=s)[0]), rtol=1e-5, atol=1e-7)
    # cross resume: each package from the other's directory, pruned to 4
    for reader, writer in (("port", "ref"), ("ref", "port")):
        d = tmp_path / f"{reader}_from_{writer}"
        d.mkdir()
        shutil.copytree(tmp_path / writer / "step_0000000004",
                        d / "step_0000000004")
        jo, to, jstate, tstate = _states()
        loop = tloop if reader == "port" else jloop
        cfg = loop.LoopConfig(total_steps=6, ckpt_every=2, log_every=0,
                              ckpt_dir=str(d), ckpt_async=False)
        if reader == "port":
            state, hist = loop.train(tstate, tts.make_train_step(_treg, to),
                                     (_t(b) for b in batches[4:]), cfg)
        else:
            state, hist = loop.train(jstate, jts.make_train_step(_jreg, jo),
                                     (_j(b) for b in batches[4:]), cfg)
        assert hist["step"] == [4, 5]
        np.testing.assert_allclose(hist["loss"], runs[writer][1]["loss"][4:],
                                   rtol=1e-5)
        _close(_named(state) if reader == "port" else _jnamed(state),
               _jnamed(runs["ref"][0]), rtol=1e-5, atol=1e-7)
    assert "resumed from step 4" in capsys.readouterr().out


def test_async_save_snapshots_before_returning(tmp_path):
    _, to, _, tstate = _states("adamw bf16")
    ck = tckpt.Checkpointer(str(tmp_path))
    before = {n: x.detach().float().clone()
              for n, x in flatten_with_names(tstate)}
    ck.save(1, tstate, block=False)
    with torch.no_grad():              # the next step writes in place
        for x in leaves(tstate):
            x.add_(1)
    ck.wait()
    back, step = ck.restore(tstate)
    assert step == 1
    for n, x in flatten_with_names(back):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      before[n].numpy(), err_msg=n)
    # bf16 moments stored as f32 under their own dtype, as the reference
    # stores them, and read back by the reference as bf16
    dtypes = {x["name"]: x["dtype"]
              for x in _manifest(ck, 1)["leaves"]}
    assert dtypes["opt_state/m/w1"] == "bfloat16"
    jo, _, jstate, _ = _states("adamw bf16")
    jback, _ = jckpt.Checkpointer(str(tmp_path)).restore(jstate)
    assert jback.opt_state.m["w1"].dtype == jnp.bfloat16
    _close(_jnamed(jback), {n: v.numpy() for n, v in before.items()})
    # and restored into tensors of the state's own dtypes, in place
    assert ck.restore_into(tstate) == 1
    assert tstate.opt_state.v["w1"].dtype == torch.bfloat16
    _close(_named(tstate), {n: v.numpy() for n, v in before.items()})


def test_sigterm_sets_preempted_and_the_loop_exits(tmp_path):
    old = signal.getsignal(signal.SIGTERM)
    try:
        event = tckpt.install_preemption_handler()
        assert not tckpt.preempted()
        os.kill(os.getpid(), signal.SIGTERM)
        assert event.wait(10) and tckpt.preempted()
        _, to, _, tstate = _states()
        cfg = tloop.LoopConfig(total_steps=6, ckpt_every=4, log_every=0,
                               ckpt_dir=str(tmp_path))
        state, hist = tloop.train(tstate, tts.make_train_step(_treg, to),
                                  (_t(b) for b in _reg_batches(6)), cfg)
        assert hist["step"] == [0]          # one step, then out
        assert tckpt.Checkpointer(str(tmp_path)).all_steps() == [1]
    finally:
        signal.signal(signal.SIGTERM, old)
        tckpt._PREEMPTED.clear()


# ---------------------------------------------------------------------------
# train cells and the launcher
# ---------------------------------------------------------------------------


def _shapes(tree):
    return [(n, tuple(x.shape), np.dtype(str(x.dtype).removeprefix("torch."))
             .name) for n, x in flatten_with_names(tree)]


@pytest.mark.parametrize("arch", RECSYS)
def test_train_cells_match_reference_at_full_size(arch):
    want = jsteps.build_cell(arch, "train_batch", jmesh.make_test_mesh((1, 1)),
                             False)
    got = tsteps.build_cell(arch, "train_batch", device="cpu")
    assert got.meta == want.meta and got.meta["kind"] == "train"
    assert got.args[0].residuals is None
    assert _shapes(got.args) == [
        (n, tuple(x.shape), np.dtype(x.dtype).name)
        for n, x in jckpt._flatten_with_names(want.args)]
    if arch == "dlrm-mlperf":
        capped = tsteps.build_cell(arch, "train_batch",
                                   variant="rows=2000000", device="cpu")
        pad = tconfigs.get_arch(arch).config.row_pad_to
        assert max(t.shape[0] for t in capped.args[0].params["tables"]) \
            == tsteps._pad_to(2_000_000, pad)
        assert capped.args[0].opt_state.m["tables"][0].shape == \
            capped.args[0].params["tables"][0].shape


@pytest.mark.parametrize("arch", ["mind", "dlrm-mlperf"])
def test_launch_train_main_on_the_cpu(arch, tmp_path):
    hist = tlaunch.main(["--arch", arch, "--preset", "smoke", "--steps", "3",
                         "--device", "cpu", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert hist["step"] == [0, 1, 2] and np.isfinite(hist["loss"]).all()
    assert tckpt.Checkpointer(str(tmp_path)).all_steps() == [2, 3]
    # a second run resumes at the end and takes no step
    again = tlaunch.main(["--arch", arch, "--steps", "3", "--device", "cpu",
                          "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert again["step"] == []


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"])
def test_launch_train_trains_the_moe_lms(arch):
    hist = tlaunch.main(["--arch", arch, "--preset", "smoke", "--steps", "3",
                         "--device", "cpu"])
    assert hist["step"] == [0, 1, 2] and np.isfinite(hist["loss"]).all()


def test_launch_train_trains_mace():
    hist = tlaunch.main(["--arch", "mace", "--preset", "smoke", "--steps",
                         "3", "--device", "cpu"])
    assert hist["step"] == [0, 1, 2] and np.isfinite(hist["loss"]).all()
