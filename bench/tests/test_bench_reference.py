"""The frozen reference against the program's plain path, at a tiny size on
the CPU: the same forest bit for bit from the same rows and seed, the same
leaves, the same candidate sets and the same answers."""
import pytest
import torch

from bench.data import iss_like, mnist_like
from bench.reference import forest as rforest
from bench.reference import search as rsearch

CASES = {
    "l2": (mnist_like, {"classes": 10, "intrinsic": 12, "latent_scale": 0.35,
                        "noise": 0.02, "structure_seed": 3}, 784),
    "chi2": (iss_like, {"models": 72, "sparsity": 0.15,
                        "structure_seed": 3}, 595),
}


def data(metric, n=2000, nq=40, seed=5):
    gen_mod, params, d = CASES[metric]
    gen = torch.Generator().manual_seed(seed)
    return gen_mod.make(params, n, nq, d, gen, torch.device("cpu"))


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    from repro_torch.core.forest import ForestConfig, build_forest
    metric = request.param
    rows, queries = data(metric)
    cfg = ForestConfig(n_trees=6, capacity=12, split_ratio=0.3, n_proj=1)
    seed = 2**31 + 77
    prog = build_forest(rows, cfg, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    ref = rforest.build(rows, 6, 12, 0.3, seed)
    return metric, rows, queries, cfg.resolved(rows.shape[0]), prog, ref


def test_forest_bitwise(built):
    _, rows, _, cfg, prog, ref = built
    assert rforest.sizes(rows.shape[0], 12, 0.3) == (cfg.max_depth,
                                                     cfg.max_nodes)
    assert rforest.count_diff(ref, prog) == 0


def test_control_forest_differs(built):
    _, rows, _, _, prog, _ = built
    ctl = rforest.build(rows, 6, 12, 0.3, 2**31 + 77, precision="bf16")
    assert rforest.count_diff(ctl, prog) > 0


@pytest.mark.parametrize("probes", [1, 4])
def test_leaves_and_candidates(built, probes):
    from repro_torch.core.forest import traverse_forest
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.search import mask_duplicates
    _, _, queries, cfg, prog, ref = built
    leaves = rsearch.descend(ref, queries, cfg.max_depth, probes)
    got = traverse_forest(prog, queries, cfg.max_depth, probes, mode="ref")
    if probes == 1:
        got = got[..., None]
    assert torch.equal(leaves, got.long())
    cand = rsearch.candidates(ref, leaves, cfg.leaf_pad)
    ids, mask = candidates(prog, queries, cfg.max_depth, cfg.leaf_pad,
                           probes, mode="ref")
    mask = mask_duplicates(ids, mask)
    for row in range(queries.shape[0]):
        want = set(cand[row][cand[row] >= 0].tolist())
        assert want == set(ids[row][mask[row]].tolist())


@pytest.mark.parametrize("probes", [1, 4])
def test_answers(built, probes):
    from repro_torch.core.pipeline import fused_query
    metric, rows, queries, cfg, prog, ref = built
    d, i = fused_query(prog, queries, rows, 10, cfg, metric=metric,
                       n_probes=probes, mode="ref", device="cpu")
    r_d, r_i, _ = rsearch.query(ref, queries, rows, 10, metric,
                                cfg.max_depth, probes, cfg.leaf_pad)
    assert torch.equal(i.long(), r_i)
    assert torch.allclose(d.double(), r_d, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_the_seed_draws_rows_from_one_distribution(metric):
    gen_mod, params, d = CASES[metric]
    again = data(metric, n=300, nq=10, seed=5)
    assert all(torch.equal(a, b) for a, b in
               zip(data(metric, n=300, nq=10, seed=5), again))
    assert not torch.equal(data(metric, n=300, nq=10, seed=6)[0], again[0])
    # the prototypes come from structure_seed alone: the mean row over many
    # draws is nearly the same for two seeds, and not for two structures
    other = dict(params, structure_seed=params["structure_seed"] + 1)
    g = torch.Generator()
    mean = [gen_mod.make(p, 4000, 1, d, g.manual_seed(s),
                         torch.device("cpu"))[0].mean(0)
            for p, s in ((params, 5), (params, 6), (other, 5))]
    assert (mean[0] - mean[1]).abs().max() < 0.3 * (
        mean[0] - mean[2]).abs().max()
