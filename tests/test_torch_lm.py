"""The port's dense language models held against the reference's:
``data/lm_data.py``, ``models/attention.py``, ``models/transformer.py``
(dense structure), ``launch/steps.py``'s LM programs and
``launch/train.py``'s ``lm`` branch.

Small configurations as ``tests/test_transformer.py`` makes them (4 layers,
d 64, 4 heads / 2 KV heads of 16, vocab 257 padded to 384).  Parameters are
the reference's ``init_lm`` trees carried into the port by
``convert.lm_from_numpy``; inputs are seeded numpy arrays.  Each reference
function is jitted once per configuration.

Tolerances: f32 values rtol 1e-5 / atol 1e-6 (the whole model's logits,
hidden states and caches, values up to ~2 after four layers: atol 1e-5,
as their f32 sums run in other orders); gradients rtol 1e-4 / atol 1e-6 x the largest
magnitude of the whole gradient; bf16 compute (the parameters f32, every
block's products in bf16): logits atol 0.03 (a few bf16 units of the
largest logit, 0.6), the loss rtol 1e-3, gradients atol 0.05 x the
gradient's largest magnitude; token streams, masks, shapes and meta
exactly.
"""
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_release import release_compiled_executables  # noqa: F401
import repro.configs as jconfigs
from repro.checkpoint import checkpointer as jckpt
from repro.configs.base import LMConfig as JLMConfig
from repro.data import lm_data as jdata
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.train import optimizer as jopt
from repro.train import train_state as jts
import repro_torch.configs as tconfigs
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell
from repro_torch.convert import lm_from_numpy, train_state_from_numpy
from repro_torch.data import lm_data as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as tts
from repro_torch.tree import flatten_with_names, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=257, remat=False,
            param_dtype="float32", compute_dtype="float32")
CONFIGS = {
    "global": {},
    "gemma": {"sliding_window": 6, "global_every": 2, "rope_base": 1e6},
    "tied": {"tie_embeddings": True},
    "softcap-blockwise-remat": {"logit_softcap": 2.0, "attn_impl":
                                "blockwise", "kv_block": 4, "remat": True},
}
DENSE_LMS = ["smollm-135m", "gemma3-4b", "stablelm-12b"]
MOE_LMS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]


def _cfgs(name, **more):
    kw = {**BASE, **CONFIGS.get(name, {}), **more}
    return JLMConfig(name="t", **kw), LMConfig(name="t", **kw)


@functools.lru_cache(maxsize=None)
def _models(name, **more):
    """(reference params, port model, reference cfg, port cfg)."""
    jc, tc = _cfgs(name, **more)
    jp = jtr.init_lm(jax.random.key(0), jc)
    return jp, lm_from_numpy(jax.device_get(jp), tc, "cpu"), jc, tc


def _tokens(b, s, seed=1, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_markov_tokens_bit_for_bit():
    j, t = jdata.MarkovTokens(257, branch=5, seed=3), \
        tdata.MarkovTokens(257, branch=5, seed=3)
    np.testing.assert_array_equal(j.successors, t.successors)
    np.testing.assert_array_equal(j.sample(4, 33), t.sample(4, 33))
    jb, tb = next(j.batches(3, 16)), next(t.batches(3, 16))
    for k in ("tokens", "labels"):
        assert jb[k].dtype == tb[k].dtype == np.int32
        np.testing.assert_array_equal(jb[k], tb[k])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 3, -1])
def test_mask(window):
    qp, kp = np.arange(4, 12, dtype=np.int32), np.arange(16, dtype=np.int32)
    want = jattn._mask(jnp.asarray(qp), jnp.asarray(kp), window)
    got = tattn._mask(torch.from_numpy(qp), torch.from_numpy(kp), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_t = tattn._mask(torch.from_numpy(qp), torch.from_numpy(kp),
                        torch.tensor(window, dtype=torch.int32))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


def _qkv(b=2, sq=8, skv=12, h=4, kv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, sq, h, dh), (b, skv, kv, dh),
                            (b, skv, kv, dh)))


@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_sdpa_and_blockwise(softcap):
    q, k, v = _qkv()
    # queries at 0..7 against keys at 4..15: rows 0-3 see no key at all
    # (NEG_INF everywhere: a uniform softmax, not NaN); window 5
    qp, kp = np.arange(8, dtype=np.int32), np.arange(4, 16, dtype=np.int32)
    extra = np.arange(12) % 5 != 2
    jmask = jattn._mask(jnp.asarray(qp), jnp.asarray(kp), 5)
    want = jax.jit(jattn._sdpa, static_argnums=4)(
        q, k, v, jmask & jnp.asarray(extra)[None], softcap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = tattn._mask(torch.from_numpy(qp), torch.from_numpy(kp), 5)
    got = tattn._sdpa(tq, tk, tv, tmask & torch.from_numpy(extra)[None],
                      softcap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.isfinite(_np(got)).all()
    jblk = jax.jit(jattn._sdpa_blockwise,
                   static_argnames=("softcap", "kv_block"))(
        q, k, v, jnp.asarray(qp), jnp.asarray(kp), 5, softcap=softcap,
        kv_block=4, extra_kmask=jnp.asarray(extra))
    tblk = tattn._sdpa_blockwise(tq, tk, tv, torch.from_numpy(qp),
                                 torch.from_numpy(kp), 5, softcap=softcap,
                                 kv_block=4,
                                 extra_kmask=torch.from_numpy(extra))
    np.testing.assert_allclose(_np(tblk), np.asarray(jblk), **TOL)
    # blockwise equals dense where a row sees a key (an all-masked row
    # averages its block's values instead of all of them)
    np.testing.assert_allclose(_np(tblk)[:, 4:], _np(got)[:, 4:], **TOL)
    with pytest.raises(AssertionError, match="block size"):
        tattn._sdpa_blockwise(tq, tk, tv, torch.from_numpy(qp),
                              torch.from_numpy(kp), 5, kv_block=5)


def _attn_params(seed=0, d=32, h=4, kv=2, dh=8):
    p = jattn.init_attention(jax.random.key(seed), d, h, kv, dh,
                             jnp.float32)
    return p, {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


ATTN_KW = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_base=1e4)


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
def test_attention_fwd_full_sequence(impl):
    jp, tp = _attn_params()
    x = np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    fn = jax.jit(functools.partial(jattn.attention_fwd, attn_impl=impl,
                                   kv_block=4, softcap=3.0, **ATTN_KW),
                 static_argnums=3)
    want, wc = fn(jp, x, pos, 3)
    got, gc = tattn.attention_fwd(tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), 3, attn_impl=impl,
                                  kv_block=4, softcap=3.0, **ATTN_KW)
    assert wc is None and gc is None
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["dense", "blockwise"])
@pytest.mark.parametrize("cache_pos", [3, 7])
def test_attention_fwd_writes_the_cache(impl, cache_pos):
    """s = 2 new tokens at ``cache_pos`` of an 8-slot cache; at 7 the write
    clamps to slots 6-7 while the written mask runs to the unclamped 8."""
    jp, tp = _attn_params(1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 32)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, 8, 2, 8)).astype(np.float32)
              for _ in range(2))
    pos = np.arange(cache_pos, cache_pos + 2, dtype=np.int32)
    fn = jax.jit(functools.partial(jattn.attention_fwd, attn_impl=impl,
                                   kv_block=4, **ATTN_KW), static_argnums=3)
    want, wc = fn(jp, x, pos, 0, cache=jattn.KVCache(ck, cv),
                  cache_pos=jnp.asarray(cache_pos, jnp.int32))
    cache = tattn.KVCache(torch.from_numpy(ck.copy()),
                          torch.from_numpy(cv.copy()))
    got, gc = tattn.attention_fwd(tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), 0, cache=cache,
                                  cache_pos=torch.tensor(cache_pos),
                                  attn_impl=impl, kv_block=4, **ATTN_KW)
    assert gc is cache                       # written in place
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g, w, old in ((gc.k, wc.k, ck), (gc.v, wc.v, cv)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
        start = min(cache_pos, 6)
        keep = [i for i in range(8) if not start <= i < start + 2]
        np.testing.assert_array_equal(_np(g)[:, keep], old[:, keep])


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def _jall(name):
    """The reference's forward, forward_hidden, and the dense and chunked
    losses with their gradients, in one jitted function."""
    jc = _models(name)[2]

    def fn(p, b):
        return (jtr.forward(p, b["tokens"], jc)[0],
                jtr.forward_hidden(p, b["tokens"], jc)[0],
                jax.value_and_grad(lambda p_: jtr.loss_fn(p_, b, jc)[0])(p),
                jax.value_and_grad(lambda p_: jtr.loss_fn(
                    p_, b, jc, logit_chunk=4)[0])(p))
    return jax.jit(fn)


def _batch(b=2, s=16, seed=1):
    tok = _tokens(b, s + 1, seed)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _grad_close(got_model, jgrads, tgrads, rtol, atol_frac):
    """The port's gradients (in the model's leaf order) against the
    reference's tree, leaf by leaf."""
    names = [n for n, _ in flatten_with_names(got_model)]
    wants = [_f32(w) for w in jax.tree.leaves(jgrads)]
    assert len(names) == len(wants) == len(tgrads)
    top = max(float(np.abs(w).max()) for w in wants)
    for name, want, got in zip(names, wants, tgrads):
        np.testing.assert_allclose(_np(got), want, rtol=rtol,
                                   atol=atol_frac * top, err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_gradients(name):
    jp, model, jc, tc = _models(name)
    batch = _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, jhidden, *jlosses = _jall(name)(jp, batch)
    np.testing.assert_allclose(_np(ttr.forward(model, tb["tokens"], tc)[0]),
                               np.asarray(jlogits), **MODEL_TOL)
    np.testing.assert_allclose(
        _np(ttr.forward_hidden(model, tb["tokens"], tc)[0]),
        np.asarray(jhidden), **MODEL_TOL)
    for (jl, jg), chunk in zip(jlosses, (0, 4)):
        loss, metrics = ttr.loss_fn(model, tb, tc, logit_chunk=chunk)
        assert set(metrics) == {"ce", "aux"}
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        grads = torch.autograd.grad(loss, leaves(model))
        _grad_close(model, jg, grads, rtol=1e-4, atol_frac=1e-6)


def test_chunked_loss_needs_whole_chunks():
    _, model, _, tc = _models("global")
    x = torch.zeros(1, 6, 64)
    with pytest.raises(ValueError, match="multiple of the logit chunk"):
        ttr.chunked_cross_entropy(x, torch.zeros(64, 384),
                                  torch.zeros(1, 6, dtype=torch.int32),
                                  257, 4)


def test_bf16_compute():
    jp, model, jc, tc = _models("gemma", compute_dtype="bfloat16")
    batch = _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.jit(lambda p, t: jtr.forward(p, t, jc)[0])(
        jp, jnp.asarray(batch["tokens"]))
    got = ttr.forward(model, tb["tokens"], tc)[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=0.03)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.loss_fn(p, b, jc)[0]))(jp, batch)
    loss, _ = ttr.loss_fn(model, tb, tc)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    grads = torch.autograd.grad(loss, leaves(model))
    _grad_close(model, jg, grads, rtol=0.0, atol_frac=0.05)


@pytest.mark.parametrize("name", ["global", "gemma", "softcap-blockwise-remat"])
def test_prefill_then_decode(name):
    """The reference's prefill (``last_only``) of 12 tokens and 4 decode
    steps against the port's, logits and cache, and the port's against its
    own forward."""
    jp, model, jc, tc = _models(name)
    tok = _tokens(2, 16, seed=5)
    jstep = jax.jit(functools.partial(jtr.decode_step, cfg=jc),
                    static_argnames="last_only")
    jcache = jtr.init_cache(jc, 2, 16, jnp.float32)
    tcache = ttr.init_cache(tc, 2, 16, torch.float32, "cpu")
    full = ttr.forward(model, torch.from_numpy(tok), tc)[0].detach()
    with torch.no_grad():
        wl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, :12]),
                           jnp.zeros((), jnp.int32), last_only=True)
        gl, gc = ttr.decode_step(model, tcache, torch.from_numpy(tok[:, :12]),
                                 torch.zeros((), dtype=torch.int32), tc,
                                 last_only=True)
        assert gc is tcache and gl.shape == (2, 1, 384)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), **MODEL_TOL)
        np.testing.assert_allclose(_np(gl[:, 0]), _np(full[:, 11]),
                                   rtol=2e-3, atol=2e-3)
        for t in range(12, 16):
            wl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.asarray(t, jnp.int32))
            gl, gc = ttr.decode_step(model, gc,
                                     torch.from_numpy(tok[:, t:t + 1]), t,
                                     tc)
            np.testing.assert_allclose(_np(gl), np.asarray(wl), **MODEL_TOL)
            np.testing.assert_allclose(_np(gl[:, 0]), _np(full[:, t]),
                                       rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(gc.k), np.asarray(jcache.k), **MODEL_TOL)
    np.testing.assert_allclose(_np(gc.v), np.asarray(jcache.v), **MODEL_TOL)


def test_moe_is_not_ported():
    """The MoE structures, which the port once refused, build on ``meta``
    with the reference's names, shapes and dtypes: granite-moe-1b's
    ``moe`` and llama4-maverick's ``dense_moe`` (at full size: 397.7B
    parameters, none allocated)."""
    for arch, struct in (("granite-moe-1b-a400m", "moe"),
                         ("llama4-maverick-400b-a17b", "dense_moe")):
        tc = tconfigs.get_arch(arch).config
        assert ttr.structure(tc) == struct
        want = jax.eval_shape(functools.partial(
            jtr.init_lm, cfg=jconfigs.get_arch(arch).config),
            jax.random.key(0))
        got = ttr.init_lm(None, tc, "meta")
        assert [(n, tuple(x.shape), str(x.dtype)[6:]) for n, x in
                flatten_with_names(got)] == [
            ("/".join(k.key for k in path), tuple(x.shape),
             np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(want)[0]]
        assert all(x.is_meta for x in leaves(got))
        pad = (tc.padded_vocab - tc.vocab_size) * tc.d_model * (
            1 if tc.tie_embeddings else 2)
        assert sum(x.numel() for x in leaves(got)) == tc.param_count() + pad


def test_lm_from_numpy_keeps_names_and_bf16():
    jc, tc = _cfgs("global", param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    jp = jtr.init_lm(jax.random.key(1), jc)
    model = lm_from_numpy(jax.device_get(jp), tc, "cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = flatten_with_names(model)
    assert [n for n, _ in got] == [
        "/".join(k.key for k in path) for path, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.requires_grad
        np.testing.assert_array_equal(_np(g), _f32(w))
    # the port's own init: the reference's tree shape and dtypes
    own = ttr.init_lm(torch.Generator().manual_seed(0), tc, "cpu")
    assert [(n, tuple(x.shape), x.dtype) for n, x in
            flatten_with_names(own)] == [(n, tuple(x.shape), x.dtype)
                                         for n, x in got]


# ---------------------------------------------------------------------------
# cell programs
# ---------------------------------------------------------------------------


def _canon(tree, leaf):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _canon(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            len(tree) == 2 and isinstance(tree[1], str)):
        return [_canon(v, leaf) for v in tree]
    return leaf(tree)


def _t_shapes(tree):
    return _canon(tree, lambda s: (tuple(s.shape),
                                   str(s.dtype).removeprefix("torch.")))


def _j_shapes(tree):
    return _canon(jax.tree.map(
        lambda s: (tuple(s.shape), np.dtype(s.dtype).name), tree),
        lambda x: x)


@pytest.mark.parametrize("arch", DENSE_LMS + MOE_LMS)
def test_lm_cells_meta_and_args_at_full_size(arch):
    mesh = jmesh.make_test_mesh((1, 1))
    for cell in jconfigs.get_arch(arch).cells:
        if cell.skip:
            with pytest.raises(ValueError, match="skipped"):
                tsteps.build_cell(arch, cell.name, device="cpu")
            continue
        want = jsteps.build_cell(arch, cell.name, mesh, False)
        got = tsteps.build_cell(arch, cell.name, device="cpu")
        assert got.meta == want.meta, cell.name
        assert _t_shapes(got.args) == _j_shapes(want.args), cell.name


def test_lm_variants():
    cut = tsteps.build_cell("gemma3-4b", "decode_32k",
                            variant="nl=6,batch=8,attn=blockwise",
                            device="cpu")
    assert cut.args[1].k.shape == (6, 8, 32768, 4, 256)
    assert cut.meta["n_tokens"] == 8
    assert cut.args[0]["layers"]["ffn"]["w_up"].shape == (6, 2560, 10240)
    with pytest.raises(ValueError, match="unknown variant key"):
        tsteps.build_cell("smollm-135m", "train_4k", variant="rows=4",
                          device="cpu")
    cfg = tsteps._apply_lm_variant(
        tconfigs.get_arch("gemma3-4b").config, "nl=6,opt=adafactor,remat=0")
    assert (cfg.n_layers, cfg.opt, cfg.remat) == (6, "adafactor", False)
    assert cfg.layer_windows == (1024,) * 5 + (0,)
    ada = tsteps.build_cell("gemma3-4b", "train_4k",
                            variant="nl=1,opt=adafactor", device="cpu")
    assert type(ada.args[0].opt_state).__name__ == "FactorState"
    assert [tsteps._logit_chunk(tconfigs.get_arch(a).config)
            for a in DENSE_LMS] == [0, 512, 512]


TINY = ArchSpec("tiny-lm", "lm", LMConfig(name="tiny-lm", **{
    **BASE, "sliding_window": 6, "global_every": 2, "param_dtype": "float32",
    "compute_dtype": "float32", "remat": True}), (
    ShapeCell("train_4k", "train", seq_len=16, global_batch=2),
    ShapeCell("prefill_32k", "prefill", seq_len=16, global_batch=2),
    ShapeCell("decode_32k", "decode", seq_len=16, global_batch=2)))


def test_lm_cell_programs_run(monkeypatch):
    """A small arch through every LM program on the CPU: three train steps
    on one batch, the chunked CE equal to the dense one, prefill against
    forward's last position, decode writing the last slot."""
    monkeypatch.setitem(tconfigs.REGISTRY, "tiny-lm", TINY)
    gen = torch.Generator().manual_seed(4)
    train = tsteps.build_cell("tiny-lm", "train_4k", device="cpu")
    state, batch = train.make_args(gen)
    assert isinstance(state.opt_state, topt.AdamState)
    before = state.params.embed.detach().clone()
    losses = []
    for _ in range(3):
        state, metrics = train.fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert int(state.step) == 3 and losses[-1] < losses[0]
    assert not torch.equal(before, state.params.embed)
    chunked = ttr.loss_fn(state.params, batch, TINY.config,
                          logit_chunk=8)[0]
    np.testing.assert_allclose(float(chunked), float(ttr.loss_fn(
        state.params, batch, TINY.config)[0]), rtol=1e-5)

    prefill = tsteps.build_cell("tiny-lm", "prefill_32k", device="cpu")
    params, cache, tokens = prefill.make_args(gen)
    logits, cache2 = prefill.fn(params, cache, tokens)
    assert cache2 is cache and cache.k.dtype == torch.bfloat16
    with torch.no_grad():
        full = ttr.forward(params, tokens, TINY.config)[0]
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, -1]),
                               rtol=2e-2, atol=2e-2)

    decode = tsteps.build_cell("tiny-lm", "decode_32k", device="cpu")
    params, cache, tokens, pos = decode.make_args(gen)
    assert int(pos) == 15 and float(cache.k.float().abs().mean()) > 0.5
    old = cache.k.clone()
    logits, _ = decode.fn(params, cache, tokens, pos)
    assert logits.shape == (2, 1, TINY.config.padded_vocab)
    assert torch.equal(cache.k[:, :, :15], old[:, :, :15])
    assert not torch.equal(cache.k[:, :, 15], old[:, :, 15])


# ---------------------------------------------------------------------------
# train state and checkpoints across packages; the launcher
# ---------------------------------------------------------------------------


def test_lm_train_state_crosses_packages(tmp_path):
    jp, _, jc, tc = _models("tied")
    jo = jopt.adamw(jopt.constant_schedule(1e-3))
    to = topt.adamw(topt.constant_schedule(1e-3))
    jstate = jts.init_train_state(jp, jo)
    batch = _batch()
    jstep = jax.jit(jts.make_train_step(lambda p, b: jtr.loss_fn(p, b, jc),
                                        jo))
    jstate, _ = jstep(jstate, batch)
    tstate = train_state_from_numpy(jax.device_get(jstate), tc, "cpu")
    assert isinstance(tstate.params, ttr.LM)
    # the port's step from the reference's state, as the reference's
    jnext, jm = jstep(jstate, batch)
    tnext, tm = tts.make_train_step(lambda p, b: ttr.loss_fn(p, b, tc), to)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    jnamed = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path): _f32(x)
              for path, x in jax.tree_util.tree_flatten_with_path(jnext)[0]}
    for name, x in flatten_with_names(tnext):
        np.testing.assert_allclose(_np(x), jnamed[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # the port's save read by the reference, and the reference's by the port
    tckpt.Checkpointer(str(tmp_path / "port")).save(2, tnext)
    back, step = jckpt.Checkpointer(str(tmp_path / "port")).restore(jnext)
    assert step == 2
    for (name, x), y in zip(flatten_with_names(tnext), jax.tree.leaves(back)):
        np.testing.assert_array_equal(_np(x), _f32(y), err_msg=name)
    jckpt.Checkpointer(str(tmp_path / "ref")).save(2, jnext)
    fresh = train_state_from_numpy(jax.device_get(jstate), tc, "cpu")
    assert tckpt.Checkpointer(str(tmp_path / "ref")).restore_into(fresh) == 2
    for (name, x), y in zip(flatten_with_names(fresh), jax.tree.leaves(jnext)):
        np.testing.assert_array_equal(_np(x), _f32(y), err_msg=name)


def test_launch_train_lm_with_seq(tmp_path):
    hist = tlaunch.main(["--arch", "smollm-135m", "--preset", "smoke",
                         "--steps", "3", "--seq", "16", "--batch", "4",
                         "--device", "cpu", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert hist["step"] == [0, 1, 2] and np.isfinite(hist["loss"]).all()
    # a first loss near log(512): the smoke vocabulary, untrained
    assert abs(hist["loss"][0] - np.log(512)) < 0.5
    assert tckpt.Checkpointer(str(tmp_path)).all_steps() == [2, 3]
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        names = [x["name"] for x in json.load(f)["leaves"]]
    assert "params/layers/attn/wq" in names and "opt_state/m/embed" in names


def test_launch_train_seq_reaches_the_recommenders():
    """The reference's ``--seq`` (fault 9): accepted for every family, and
    ignored by the recommenders."""
    hist = tlaunch.main(["--arch", "mind", "--steps", "1", "--seq", "64",
                         "--device", "cpu"])
    assert hist["step"] == [0] and np.isfinite(hist["loss"]).all()


def test_knn_lm_example_small():
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import knn_lm_torch
    finally:
        sys.path.pop(0)
    out = knn_lm_torch.main(["--device", "cpu", "--steps", "60"])
    assert out["recall"] >= 0.8 and out["loss"][-1] < out["loss"][0]
    assert set(out["acc"]) == {0.0, 0.3, 0.6}
