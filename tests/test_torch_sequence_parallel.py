"""Sequence parallelism of the port's denoiser (``WaveNet(sp=...)``,
``prodiff_tpu_torch/parallel/halo.py``) vs the JAX ``WaveNet(sp_axis=...)``,
on the CPU.

The ranks run in worker processes (``tests/torch_parallel_worker.py``'s
``sp_module``: gloo, started by ``parallel.mesh.launch_local``); the JAX side
runs here, on conftest's 8 virtual devices.

- the windows: ``torch.tensor_split``'s blocks, each widened by the halo and
  clipped to the sequence, their frames received from exactly the ranks
  that own them (pure, no ranks);
- two ranks on ``tests/test_tp_wavenet.py``'s fixture (B=4, T=24, 4 layers
  of 128 channels) at dilation cycle 1 and 2: the gathered output vs the
  JAX ``sp_net`` on a (4, 2) mesh (atol 2e-5, rtol 1e-4), and the gradients
  of ``sum(out * probe)`` (every parameter, summed over the ranks, and the
  gathered inputs) vs ``jax.grad`` of the unsharded JAX forward (atol 1e-4,
  rtol 1e-3); the same at cycle 1 on the card's route (``on_kernels``
  patched: ``differentiable_stack``, K5's plain twins on the CPU);
- three ranks at T=10 and 4 layers: the blocks 4, 3, 3 frames, shorter
  than the 4-frame halo, so rank 0's window spans rank 2's block; held
  against the port's unsharded forward and its gradients, and the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu.models.wavenet import WaveNet as JaxWaveNet
from prodiff_tpu.parallel.mesh import create_mesh as jax_create_mesh
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.parallel.halo import SequenceParallel, Window, block_bounds, halo_width
from prodiff_tpu_torch.parallel.mesh import Mesh
from prodiff_tpu_torch.utils.convert import wavenet_state_dict
from tests.test_torch_parallel import run_ranks

IN_DIMS, HIDDEN, CHANNELS = 16, 32, 128


# ---- the windows ---------------------------------------------------------------------

@pytest.mark.parametrize("layers,cycle,want", [(20, 1, 20), (4, 1, 4), (4, 2, 6), (6, 3, 14)])
def test_halo_width_is_the_sum_of_dilations(layers, cycle, want):
    assert halo_width(layers, cycle) == want
    jax_dilations = [2 ** (i % cycle) for i in range(layers)]  # the JAX module's layers
    assert halo_width(layers, cycle) == sum(jax_dilations)


@pytest.mark.parametrize("t,n,h", [(24, 2, 4), (10, 3, 4), (8191, 2, 20), (5, 4, 6), (7, 3, 1)])
def test_windows_cover_the_halo_from_its_owners(t, n, h):
    """Blocks are ``torch.tensor_split``'s; each window is its block and h
    frames a side clipped to [0, T), made of the block and the frames each
    other rank sends, which are that rank's ``gives`` to this one."""
    lengths = [p.shape[0] for p in torch.tensor_split(torch.arange(t), n)]
    bounds = block_bounds(lengths)
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    for r in range(n):
        win = Window(bounds, r, h)
        lo, hi = bounds[r]
        assert win.span == (max(0, lo - h), min(t, hi + h))
        covered = np.zeros(t, int)
        covered[lo:hi] += 1
        for s in range(n):
            if s == r:
                continue
            a, b = win.needs(s)
            if b > a:
                covered[a:b] += 1
                assert (a, b) == Window(bounds, s, h).gives(r)
        start, stop = win.span
        assert (covered[start:stop] == 1).all() and covered.sum() == stop - start
        assert np.arange(t)[start:stop][win.cut].tolist() == list(range(lo, hi))


def test_mesh_sp_is_the_model_axis():
    grid = np.arange(4).reshape(2, 2)
    assert Mesh(np.arange(2).reshape(2, 1), 1, torch.device("cpu")).sp is None
    assert Mesh(grid, 3, torch.device("cpu")).sp == SequenceParallel(None, 1, 2)


# ---- the module vs JAX ---------------------------------------------------------------

def _case(rng, b, t, layers, cycle):
    """Seeded JAX weights (perturbed as ``tests/test_tp_wavenet.py``'s) and
    inputs; the JAX ``sp_net`` output on a (4, 2) mesh, the unsharded output
    and ``jax.grad`` of ``sum(out * probe)`` in params, x and cond."""
    kw = dict(in_dims=IN_DIMS, hidden_size=HIDDEN, residual_layers=layers,
              residual_channels=CHANNELS, dilation_cycle_length=cycle, use_pallas=False)
    net = JaxWaveNet(**kw)
    x = rng.normal(size=(b, t, IN_DIMS)).astype(np.float32)
    steps = np.arange(b, dtype=np.int32)
    cond = rng.normal(size=(b, t, HIDDEN)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(0), x, steps, cond)
    params = jax.tree.map(
        lambda a: a if a.ndim == 0 else a + 0.01 * np.random.default_rng(1)
        .normal(size=a.shape).astype(np.float32), params)
    probe = np.random.default_rng(3).normal(size=(b, t, IN_DIMS)).astype(np.float32)
    with jax.set_mesh(jax_create_mesh(8, model_parallel=2)):
        sp_out = np.asarray(jax.jit(JaxWaveNet(**kw, sp_axis="model").apply)(params, x, steps, cond))
    out = np.asarray(net.apply(params, x, steps, cond))
    grads = jax.jit(jax.grad(lambda p, x_, c_: jnp.sum(net.apply(p, x_, steps, c_) * probe),
                             argnums=(0, 1, 2)))(params, x, cond)
    return dict(sd=wavenet_state_dict(params["params"], layers, prefix=""), x=x, t=steps,
                cond=cond, probe=probe, sp_out=sp_out, out=out,
                grads=wavenet_state_dict(jax.tree.map(np.asarray, grads[0])["params"], layers,
                                         prefix=""),
                x_grad=np.asarray(grads[1]), cond_grad=np.asarray(grads[2]), layers=layers,
                cycle=cycle)


def _npz(path, case, kernels=False):
    np.savez(path, **{k: v.numpy() for k, v in case["sd"].items()},
             cfg=np.asarray([IN_DIMS, HIDDEN, case["layers"], CHANNELS, case["cycle"]]),
             **{f"in.{k}": case[k] for k in ("x", "t", "cond", "probe")},
             **({"in.kernels": np.asarray(True)} if kernels else {}))
    return path


def _grads_close(got, want):
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, atol=1e-4, rtol=1e-3, err_msg=n)
    for k in ("x_grad", "cond_grad"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX cases at cycle 1 and 2 on the fixture's sizes and one
    ``sp_module`` run of two ranks over them (and cycle 1 on the card's
    route)."""
    rng = np.random.default_rng(3407)
    cases = {c: _case(rng, 4, 24, 4, c) for c in (1, 2)}
    tmp = tmp_path_factory.mktemp("sp_two")
    npzs = [_npz(tmp / "c1.npz", cases[1]), _npz(tmp / "c2.npz", cases[2]),
            _npz(tmp / "k1.npz", cases[1], kernels=True)]
    ranks = run_ranks("sp_module", 2, tmp / "ranks", *npzs)
    return cases, {"c1": [r[0] for r in ranks], "c2": [r[1] for r in ranks],
                   "k1": [r[2] for r in ranks]}


@pytest.mark.parametrize("route", ["c1", "c2", "k1"])
def test_sp_forward_matches_jax_sp_net(two_ranks, route):
    """Each rank's block (T=24 over 2 ranks: 12 each), gathered, is the JAX
    sequence-sharded forward; both ranks gather the same output."""
    cases, runs = two_ranks
    case = cases[int(route[1])]
    r0, r1 = runs[route]
    assert (r0["block"], r1["block"]) == (12, 12)
    assert torch.equal(r0["out"], r1["out"])
    np.testing.assert_allclose(r0["out"], case["sp_out"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("route", ["c1", "c2", "k1"])
def test_sp_grads_match_jax(two_ranks, route):
    """Each rank's parameter gradients are its block's share; summed over
    the two ranks they are the unsharded JAX gradient, as are the input
    gradients each block got back from the other rank's halo."""
    cases, runs = two_ranks
    r0, r1 = runs[route]
    for n in r0["grads"]:
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    _grads_close(r0, cases[int(route[1])])


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """T=10 over three ranks at 4 layers (halo 4 at cycle 1, 6 at cycle 2)."""
    rng = np.random.default_rng(11)
    cases = {c: _case(rng, 2, 10, 4, c) for c in (1, 2)}
    tmp = tmp_path_factory.mktemp("sp_three")
    npzs = [_npz(tmp / "c1.npz", cases[1]), _npz(tmp / "c2.npz", cases[2]),
            _npz(tmp / "k1.npz", cases[1], kernels=True)]
    ranks = run_ranks("sp_module", 3, tmp / "ranks", *npzs)
    return cases, {"c1": [r[0] for r in ranks], "c2": [r[1] for r in ranks],
                   "k1": [r[2] for r in ranks]}


@pytest.mark.parametrize("route", ["c1", "c2", "k1"])
def test_sp_blocks_shorter_than_the_halo(three_ranks, route):
    """Blocks of 4, 3 and 3 frames against a halo of 4 (6 at cycle 2): the
    gathered output and every gradient equal the port's unsharded forward's
    and the JAX one's."""
    cases, runs = three_ranks
    case = cases[int(route[1])]
    assert [r["block"] for r in runs[route]] == [4, 3, 3]
    net = WaveNet(IN_DIMS, HIDDEN, case["layers"], CHANNELS, case["cycle"])
    net.load_state_dict({k: torch.as_tensor(v) for k, v in case["sd"].items()})
    x = torch.from_numpy(case["x"]).requires_grad_()
    cond = torch.from_numpy(case["cond"]).requires_grad_()
    out = net(x, torch.from_numpy(case["t"]), cond)
    (out * torch.from_numpy(case["probe"])).sum().backward()
    one = {"grads": {n: p.grad for n, p in net.named_parameters()}, "x_grad": x.grad,
           "cond_grad": cond.grad}
    for r in runs[route]:
        np.testing.assert_allclose(r["out"], out.detach(), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(r["out"], case["out"], atol=2e-5, rtol=1e-4)
        _grads_close(r, one)
        _grads_close(r, case)
