"""``train_state.make_dp_train_step`` over two ranks, held against the
reference's shard_map step on a 2-device CPU mesh.

The reference runs in a subprocess with 2 forced host devices; the port in a
second one that spawns two gloo ranks and imports neither JAX nor the
reference.  Both take 3 AdamW steps of a two-layer regression (a dict of
arrays) from one state on one global batch of 16 a step, split over the two
data-parallel shards, plainly and through the int8 error-feedback
all-reduce.  Losses within rtol 1e-4, parameters within atol 1e-5; both
ranks end with the same state bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the regression's parameters and batches, from one seed in both scripts
COMMON = """
import numpy as np


def reg_params():
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(6, 8)) / 3).astype(np.float32),
            "b1": np.zeros((8,), np.float32),
            "w2": (rng.normal(size=(8, 1)) / 3).astype(np.float32)}


def reg_batches(n=3, b=16):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, 6)).astype(np.float32)
        out.append({"x": x, "y": np.sin(x.sum(-1, keepdims=True))
                    .astype(np.float32)})
    return out
"""

REFERENCE = COMMON + """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
from repro import compat
from repro.train import optimizer as jopt, train_state as jts


def loss_fn(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - b["y"]) ** 2), {}


mesh = compat.make_mesh((2,), ("data",))
out = {}
for compress in (False, True):
    opt = jopt.adamw(jopt.cosine_schedule(0.05, 1, 3))
    state = jts.init_train_state(jax.tree.map(jnp.asarray, reg_params()),
                                 opt, compress=compress)
    step = jts.make_dp_train_step(loss_fn, opt, mesh, "data", compress)
    for i, b in enumerate(reg_batches()):
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        out[f"{compress}_loss_{i}"] = np.asarray(m["loss"])
    for k, v in state.params.items():
        out[f"{compress}_{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""

RANKS = COMMON + """
import os, sys
import torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.train import optimizer as topt, train_state as tts


def loss_fn(p, b):
    h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] - b["y"]) ** 2), {}


def main(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "store"), rank=rank, world_size=2)
    try:
        out = {}
        for compress in (False, True):
            opt = topt.adamw(topt.cosine_schedule(0.05, 1, 3))
            params = {k: torch.tensor(v, requires_grad=True)
                      for k, v in reg_params().items()}
            state = tts.init_train_state(params, opt, compress=compress)
            step = tts.make_dp_train_step(loss_fn, opt, compress=compress)
            for i, b in enumerate(reg_batches()):
                shard = {k: torch.from_numpy(v[8 * rank:8 * rank + 8])
                         for k, v in b.items()}
                state, m = step(state, shard)
                out[f"{compress}_loss_{i}"] = m["loss"].numpy()
            for k, v in state.params.items():
                out[f"{compress}_{k}"] = v.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(main, args=(sys.argv[1],), nprocs=2, join=True)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's arrays), both scripts run once,
    side by side."""
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = []
    for name, code, arg in (("ref.py", REFERENCE, tmp / "ref.npz"),
                            ("ranks.py", RANKS, tmp)):
        (tmp / name).write_text(code)
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / name), str(arg)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    out = []
    for name in ("ref", "rank0", "rank1"):
        with np.load(tmp / f"{name}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_two_gloo_ranks_step_as_the_reference_mesh(compress, runs):
    want, *ranks = ({k: v for k, v in r.items()
                     if k.startswith(f"{compress}_")} for r in runs)
    assert sorted(ranks[0]) == sorted(want) and len(want) == 6
    for k in want:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
        if "_loss_" in k:
            np.testing.assert_allclose(ranks[0][k], want[k], rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(ranks[0][k], want[k], rtol=0,
                                       atol=1e-5, err_msg=k)
