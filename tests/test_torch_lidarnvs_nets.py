"""The classical baselines' nets in the port (lidarnerf_tpu_torch/lidarnvs/)
against the JAX package's (lidarnerf_tpu/lidarnvs/), on the CPU.

The same inputs, made by numpy from a seed, and the same weights (the JAX
package's init through the weight bridge in utils/params.py) go through
both: the ray-drop MLP and its Adam trainer, the UNet in training and
evaluation mode at even and odd sizes with either upsampling, flax's
BatchNorm statistics, the dice metrics, the UNet trainer's optax update,
the plateau scheduler, and checkpoints both ways. Each case states its
tolerance.

The UNet trainer's steps are held in float64 in both packages: in float32
the training-mode gradient is ill-conditioned in both (flax's E[x^2] -
E[x]^2 batch variance over a few pixels at the bottleneck), each package's
float32 gradient lying up to ~20% from the float64 one on some leaves, so
float32 runs agree only in their forward values.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarnerf_tpu.lidarnvs import raydrop_pcgen as jpcgen
from lidarnerf_tpu.lidarnvs import raydrop_unet as junet_tr
from lidarnerf_tpu.lidarnvs import unet as junet
from lidarnerf_tpu_torch.lidarnvs import raydrop_pcgen, raydrop_unet, unet
from lidarnerf_tpu_torch.utils.params import (
    _flat,
    raydrop_params_from_jax,
    raydrop_params_to_jax,
    unet_params_from_jax,
    unet_params_to_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two intra-op threads: the UNet cases are the file's cost, and the
    workers of a parallel test run share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rays(n, seed=0):
    """[n, 6] packed rays: unit directions, depths to 50, intensities, a target."""
    rs = np.random.RandomState(seed)
    dirs = rs.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return np.concatenate([dirs, rs.rand(n, 1) * 50, rs.rand(n, 1), dirs[:, 2:3] < 0],
                          1).astype(np.float32)


def _worst(a_tree, b_tree):
    """max over leaves of max|a - b| / max|a|."""
    fa, fb = dict(_flat(a_tree)), dict(_flat(b_tree))
    assert fa.keys() == fb.keys()
    return max(np.abs(np.asarray(fa[k]) - fb[k]).max() / max(np.abs(fa[k]).max(), 1e-30)
               for k in fa)


# ---------------------------------------------------------------- ray-drop MLP


@pytest.mark.parametrize("i_embed", [-1, 0])
def test_raydrop_forward_matches_flax(i_embed):
    """run_network through the bridged weights, 1e-6 relative to max|logit|."""
    jt = jpcgen.RayDropTrainer(i_embed=i_embed)
    pt = raydrop_pcgen.RayDropTrainer(i_embed=i_embed, device="cpu")
    assert pt.input_ch == jt.input_ch == (5 if i_embed == -1 else 81)
    pt.model.load_state_dict(raydrop_params_from_jax(jax.device_get(jt.params)))
    x = _rays(4096)[:, :5]
    want = np.asarray(jpcgen.run_network(jnp.asarray(x), jt.model, jt.params, jt.embed_fn,
                                         jt.embeddirs_fn))
    with torch.no_grad():
        got = raydrop_pcgen.run_network(torch.from_numpy(x), pt.model, pt.embed_fn,
                                        pt.embeddirs_fn).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(pt.predict(x), jt.predict(x), rtol=0, atol=1e-6)


def test_raydrop_init_is_kaiming_normal_with_zero_biases():
    """The port's own init: std sqrt(2 / fan_in) (within 3% on 128 x 128), zero biases,
    the same weights from the same seed, others from another."""
    a = raydrop_pcgen.RayDrop(81, D=4, W=128, generator=torch.Generator().manual_seed(0))
    b = raydrop_pcgen.RayDrop(81, D=4, W=128, generator=torch.Generator().manual_seed(0))
    c = raydrop_pcgen.RayDrop(81, D=4, W=128, generator=torch.Generator().manual_seed(1))
    w = a.layers[1].weight.detach()
    assert abs(w.std().item() / np.sqrt(2 / 128) - 1) < 0.03
    assert all(not layer.bias.detach().any() for layer in a.layers)
    assert torch.equal(a.layers[0].weight, b.layers[0].weight)
    assert not torch.equal(a.layers[0].weight, c.layers[0].weight)


@pytest.mark.parametrize("cos_lr", [False, True], ids=["exponential", "cosine"])
@pytest.mark.parametrize("i_embed", [-1, 0])
def test_raydrop_trainer_matches_optax(cos_lr, i_embed):
    """20 Adam steps from the same weights on the same batches (the trainers'
    own RandomState(0) shuffles over 3000 rays in 512-ray batches, so the
    data wraps into a second epoch): the losses within 2e-5 relative and every
    parameter within 1e-5 of its leaf's max|p|, at the trainers' default lrate
    5e-4 (at 5e-3 the two float32 runs drift apart by ~1e-3 in 20 steps, the
    updates amplifying rounding in both alike)."""
    kw = dict(netdepth=2, netwidth=32, i_embed=i_embed, lrate_decay=1, n_iters=20, cos_lr=cos_lr)
    jt = jpcgen.RayDropTrainer(**kw)
    pt = raydrop_pcgen.RayDropTrainer(**kw, device="cpu")
    pt.model.load_state_dict(raydrop_params_from_jax(jax.device_get(jt.params)))
    rays = _rays(3000)
    lj = jt.train(rays, N_rand=512, verbose=False)
    lp = pt.train(rays, N_rand=512, verbose=False)
    np.testing.assert_allclose(lp, lj, rtol=2e-5)
    assert pt.count == 20
    assert _worst(jax.device_get(jt.params), raydrop_params_to_jax(pt.model.state_dict())) < 1e-5


def test_raydrop_lr_schedules_match_optax():
    """lr(k) for the k-th update (from 0): lrate * 0.1 ** (k / (lrate_decay * 1000))
    and the cosine schedule indexed at min(k, len - 1), as the JAX trainer's
    float32 schedule functions give them, 1e-6 relative."""
    for cos_lr in (False, True):
        pt = raydrop_pcgen.RayDropTrainer(lrate=5e-3, lrate_decay=2, n_iters=50, cos_lr=cos_lr,
                                          device="cpu")
        sched = jnp.asarray(jpcgen.cosine_scheduler(5e-3, 5e-5, 50))
        for k in (0, 1, 7, 49, 50, 1999, 12345):
            want = (sched[jnp.minimum(k, len(sched) - 1)] if cos_lr
                    else 5e-3 * 0.1 ** (jnp.int32(k) / (2 * 1000)))
            np.testing.assert_allclose(pt.lr_fn(k), float(want), rtol=1e-6)


def test_raydrop_checkpoints_cross_both_ways(tmp_path):
    """A JAX checkpoint loaded by the port predicts what the JAX trainer
    predicts, and the reverse (5e-6 on probabilities: float32 products over
    depths to 50 in two orders); the pickles hold the same layout and
    global_step."""
    rays = _rays(2048, seed=3)
    jt = jpcgen.RayDropTrainer(i_embed=-1, basedir=str(tmp_path), expname="jax")
    jt.train(rays, N_rand=256, n_iters=5, verbose=False)
    pt = raydrop_pcgen.RayDropTrainer(i_embed=-1, basedir=str(tmp_path), expname="port",
                                      seed=7, device="cpu")
    pt.train(rays, N_rand=256, n_iters=5, verbose=False)
    j_path, p_path = jt.save_checkpoint(5), pt.save_checkpoint(5)

    p_from_j = raydrop_pcgen.RayDropTrainer(i_embed=-1, device="cpu")
    assert p_from_j.load_checkpoint(j_path) == 5
    np.testing.assert_allclose(p_from_j.predict(rays[:, :5]), jt.predict(rays[:, :5]), atol=5e-6)
    j_from_p = jpcgen.RayDropTrainer(i_embed=-1)
    assert j_from_p.load_checkpoint(p_path) == 5
    np.testing.assert_allclose(j_from_p.predict(rays[:, :5]), pt.predict(rays[:, :5]), atol=5e-6)
    with open(p_path, "rb") as f:
        ckpt = pickle.load(f)
    with open(j_path, "rb") as f:
        ref = pickle.load(f)
    assert ckpt.keys() == ref.keys()
    assert jax.tree_util.tree_structure(ckpt["network_fn_state_dict"]) == \
        jax.tree_util.tree_structure(jax.tree.map(np.asarray, ref["network_fn_state_dict"]))


# ------------------------------------------------------------------------ UNet


def _unet_pair(bilinear, H, W, seed=1):
    """A flax UNet's variables (batch stats moved off their init) and the port's
    UNet holding them."""
    jn = junet.UNet(bilinear=bilinear)
    v = jn.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 10)), train=False)
    rs = np.random.RandomState(seed)
    params = jax.device_get(v["params"])
    bs = jax.tree.map(lambda a: np.asarray(a) + rs.rand(*a.shape).astype(np.float32) * 0.5,
                      v["batch_stats"])
    net = unet.UNet(bilinear=bilinear)
    net.load_state_dict(unet_params_from_jax(params, bs))
    return jn, params, bs, net


@pytest.mark.parametrize("bilinear", [False, True], ids=["transposed", "bilinear"])
@pytest.mark.parametrize("H,W", [(16, 32), (18, 34)], ids=["16x32", "18x34"])
def test_unet_forward_matches_flax(H, W, bilinear):
    """Logits in evaluation mode (running statistics) and in training mode
    (batch statistics) within 1e-4 of max|logit|, and the running statistics
    the training forward leaves within 1e-6; at 18 x 34 the pools floor (18 ->
    9 -> 4 -> 2 -> 1, 34 -> 17 -> 8 -> 4 -> 2) and `Up` pads."""
    jn, params, bs, net = _unet_pair(bilinear, H, W)
    x = np.random.RandomState(0).randn(2, H, W, 10).astype(np.float32)
    want = np.asarray(jn.apply({"params": params, "batch_stats": bs}, x, train=False))
    net.eval()
    with torch.no_grad():
        got = net.predict_nhwc(torch.from_numpy(x)).numpy()
    assert got.shape == (2, H, W, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    want, mutated = jn.apply({"params": params, "batch_stats": bs}, x, train=True,
                             mutable=["batch_stats"])
    net.train()
    with torch.no_grad():
        got = net.predict_nhwc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    _, new_bs = unet_params_to_jax(net.state_dict())
    assert _worst(jax.device_get(mutated["batch_stats"]), new_bs) < 1e-6


def test_batchnorm_moves_the_running_variance_by_the_biased_variance():
    """After a training forward, running_var = 0.99 var0 + 0.01 * the biased
    batch variance, as flax's (1e-6); torch's BatchNorm2d (momentum 0.01)
    would move it by the unbiased one, n / (n - 1) larger: 2x at n = 2."""
    import flax.linen as fnn

    x = np.random.RandomState(0).randn(1, 1, 2, 6).astype(np.float32) * 3 + 1  # n = 2 a channel
    bn = unet.BatchNorm(6).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    jbn = fnn.BatchNorm(use_running_average=False)
    v = jbn.init(jax.random.PRNGKey(0), x)
    jy, mut = jbn.apply(v, x, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy), atol=1e-5)
    biased = x.reshape(2, 6).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.99 + 0.01 * biased, rtol=1e-6)
    tbn = torch.nn.BatchNorm2d(6, momentum=0.01).train()
    tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tbn.running_var.numpy(), 0.99 + 0.01 * 2 * biased, rtol=1e-5)


def test_transposed_conv_bridge_flips_the_kernel():
    """flax's ConvTranspose((2, 2), strides 2) with an asymmetric kernel and the
    port's ConvTranspose2d with the bridged kernel give the same output
    (1e-6); the kernel unflipped would not."""
    import flax.linen as fnn

    rs = np.random.RandomState(0)
    x = rs.randn(1, 3, 5, 4).astype(np.float32)
    ct = fnn.ConvTranspose(2, (2, 2), strides=(2, 2))
    v = ct.init(jax.random.PRNGKey(0), x)
    kernel = rs.randn(2, 2, 4, 2).astype(np.float32)
    want = np.asarray(ct.apply({"params": {"kernel": kernel, "bias": np.zeros(2, np.float32)}}, x))
    up = unet.Up(4, 2, 2)
    sd = unet_params_from_jax({"Up_0": {"ConvTranspose_0": {"kernel": kernel,
                                                             "bias": np.zeros(2)}}}, {})
    up.up.load_state_dict({"weight": sd["up1.up.weight"], "bias": sd["up1.up.bias"]})
    with torch.no_grad():
        got = up.up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 6, 10, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    with torch.no_grad():
        up.up.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy()))
        unflipped = up.up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - want).max() > 0.1


@pytest.mark.parametrize("shape", [(8, 8), (3, 8, 8), (2, 3, 8, 8)], ids=["2d", "3d", "4d"])
def test_dice_matches_jax(shape):
    """dice_coeff (both reductions, an empty target) and dice_loss (single and
    multiclass), 1e-6."""
    rs = np.random.RandomState(0)
    pred = rs.rand(*shape).astype(np.float32)
    target = (rs.rand(*shape) > 0.5).astype(np.float32)
    empty = np.zeros(shape, np.float32)
    for p, t in [(pred, target), (empty, empty), (pred, empty)]:
        for rbf in (False, True):
            np.testing.assert_allclose(
                float(unet.dice_coeff(torch.from_numpy(p), torch.from_numpy(t), rbf)),
                float(junet.dice_coeff(jnp.asarray(p), jnp.asarray(t), rbf)), rtol=1e-6)
    for multiclass in ([False, True] if len(shape) == 4 else [False]):
        np.testing.assert_allclose(
            float(unet.dice_loss(torch.from_numpy(pred), torch.from_numpy(target), multiclass)),
            float(junet.dice_loss(jnp.asarray(pred), jnp.asarray(target), multiclass)),
            rtol=1e-6)


def _frames(n, H, W, seed):
    rs = np.random.RandomState(seed)
    return [{"hit_masks": (rs.rand(H, W) > 0.3).astype(np.float32),
             "hit_depths": rs.rand(H, W) * 10, "hit_normals": rs.rand(H, W, 3),
             "hit_incidences": rs.rand(H, W), "intensities": rs.rand(H, W),
             "rays_d": rs.rand(H, W, 3),
             "raydrop_masks": (rs.rand(H, W) > 0.5).astype(np.float32)} for _ in range(n)]


def test_unet_trainer_steps_match_optax_in_float64():
    """3 updates at batch 2 from the same weights (the last at a plateau scale
    of 0.1) in float64 in both packages: the losses within 1e-9 relative and
    every parameter and running statistic within 1e-9 of its leaf's max. The
    order holds: weight decay into every gradient, the global-norm clip to
    1, RMS scaling with eps inside the root, the 0.999 trace, lr x scale."""
    batches = [junet_tr.RaydropDataset.collate(f)
               for f in np.split(np.array(_frames(6, 16, 32, seed=0)), 3)]
    jt = junet_tr.UNetRaydropTrainer(learning_rate=1e-3, weight_decay=1e-2)
    p0, b0 = jax.device_get(jt.params), jax.device_get(jt.batch_stats)
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p0)
        bs = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), b0)
        opt = jt.optimizer.init(params)
        lj = []
        for (im, m), scale in zip(batches, (1.0, 1.0, 0.1)):
            params, bs, opt, loss = jt._step(params, bs, opt, jnp.asarray(im, jnp.float64),
                                             jnp.asarray(m, jnp.float64), scale)
            lj.append(float(loss))
        params, bs = jax.device_get(params), jax.device_get(bs)
    finally:
        jax.config.update("jax_enable_x64", False)

    pt = raydrop_unet.UNetRaydropTrainer(learning_rate=1e-3, weight_decay=1e-2, device="cpu")
    pt.model.load_state_dict(unet_params_from_jax(p0, b0))
    pt.model.double()
    pt.params = list(pt.model.parameters())
    pt.nu = [torch.zeros_like(p) for p in pt.params]
    pt.trace = [torch.zeros_like(p) for p in pt.params]
    lp = [float(pt.step(im.astype(np.float64), m.astype(np.float64), scale))
          for (im, m), scale in zip(batches, (1.0, 1.0, 0.1))]
    np.testing.assert_allclose(lp, lj, rtol=1e-9)
    pp, pb = unet_params_to_jax(pt.model.state_dict())
    assert _worst(params, pp) < 1e-9
    assert _worst(bs, pb) < 1e-9
    assert _worst(p0, pp) > 1e-4  # the weights moved


def test_unet_trainer_float32_first_loss_and_history(tmp_path):
    """The port's train() on pickles in float32 from the JAX trainer's weights:
    the first step's loss (a forward) within 1e-5 of the JAX step's, one
    checkpoint an epoch, the history's keys, and a falling loss over 8 steps
    at lr 1e-3 on a learnable target (the mask = hit_masks)."""
    frames = _frames(4, 16, 32, seed=1)
    for f in frames:
        f["raydrop_masks"] = f["hit_masks"].copy()
    for split, fs in (("train", frames), ("test", frames[:2])):
        with open(tmp_path / f"{split}_data.pkl", "wb") as f:
            pickle.dump(fs, f)
    jt = junet_tr.UNetRaydropTrainer(learning_rate=1e-3)
    im, m = junet_tr.RaydropDataset.collate([frames[i] for i in np.random.RandomState(0)
                                             .permutation(4)[:2]])
    _, _, _, want = jt._step(jt.params, jt.batch_stats, jt.opt_state, jnp.asarray(im),
                             jnp.asarray(m), 1.0)
    pt = raydrop_unet.UNetRaydropTrainer(learning_rate=1e-3, device="cpu")
    pt.model.load_state_dict(unet_params_from_jax(jax.device_get(jt.params),
                                                  jax.device_get(jt.batch_stats)))
    hist = pt.train(tmp_path, tmp_path / "ckpt", epochs=4, batch_size=2, verbose=False)
    np.testing.assert_allclose(hist[0]["losses"][0], float(want), rtol=1e-5)
    assert [h["epoch"] for h in hist] == [1, 2, 3, 4]
    assert all({"epoch", "loss", "dice", "losses"} <= h.keys() for h in hist)
    assert all((tmp_path / "ckpt" / f"checkpoint_epoch{e}.ckpt").exists() for e in (1, 2, 3, 4))
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_reduce_lr_on_plateau_sequence():
    """The port's scheduler gives the JAX one's scales on a sequence with
    rises, ties and long plateaus (mode max, patience 5, factor 0.1)."""
    seq = [0.1, 0.2, 0.2, 0.15, 0.3] + [0.3] * 6 + [0.29] * 7 + [0.5] + [0.4] * 13
    a, b = raydrop_unet.ReduceLROnPlateau(), junet_tr.ReduceLROnPlateau()
    got = [a.step(v) for v in seq]
    assert got == [b.step(v) for v in seq]
    assert got[9] == 1.0 and got[10] == pytest.approx(0.1) and got[-1] == pytest.approx(1e-4)
    lo, lo_j = (raydrop_unet.ReduceLROnPlateau(mode="min"),
                junet_tr.ReduceLROnPlateau(mode="min"))
    assert [lo.step(v) for v in seq] == [lo_j.step(v) for v in seq]


def test_unet_checkpoints_cross_both_ways(tmp_path):
    """A JAX UNet checkpoint loaded by the port predicts what the JAX trainer
    predicts, and the reverse, on an odd-sized frame (evaluation mode,
    probabilities within 1e-5); the pickles hold the same trees."""
    x = np.random.RandomState(2).rand(1, 18, 34, 10).astype(np.float32)
    jt = junet_tr.UNetRaydropTrainer(seed=3)
    jt.batch_stats = jax.tree.map(lambda a: a + 0.25, jt.batch_stats)
    jt.save_checkpoint(tmp_path / "jax.ckpt")
    pt = raydrop_unet.UNetRaydropTrainer(device="cpu")
    pt.load_checkpoint(tmp_path / "jax.ckpt")
    np.testing.assert_allclose(pt.predict(x), jt.predict(x), atol=1e-5)

    pt2 = raydrop_unet.UNetRaydropTrainer(seed=5, device="cpu")
    with torch.no_grad():
        pt2.model.inc.bn1.running_var.mul_(2.0)
    pt2.save_checkpoint(tmp_path / "port.ckpt")
    jt2 = junet_tr.UNetRaydropTrainer()
    jt2.load_checkpoint(tmp_path / "port.ckpt")
    np.testing.assert_allclose(jt2.predict(x), pt2.predict(x), atol=1e-5)
    with open(tmp_path / "port.ckpt", "rb") as f:
        ckpt = pickle.load(f)
    assert jax.tree_util.tree_structure(ckpt) == jax.tree_util.tree_structure(
        jax.device_get({"params": jt.params, "batch_stats": jt.batch_stats}))
