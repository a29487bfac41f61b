"""The `--fast` sampler: the occupancy-prior depths of a ray batch in one call.

    z = occ_z_vals(nears, fars, occ_bin_pdf(grid, ...), num_steps, perturb)

with the occupied volume occ3 = occupied_volume(grid, cfg) as its input
(models/occupancy.py; the JAX package computes both functions in XLA). A
CUDA tensor takes the hand-written kernel (`ops/occ_sample_cuda.py`,
`csrc/occ_sample.cu`: P12's bin lookup, tools/exp_occ_lookup.py, fused with
the bin cells, the pdf and the stratified inverse CDF), which equals the
plain composition on the card bit for bit; a CPU tensor takes the plain
version below. Neither falls back to the other. The draws are those of
`occ_z_vals`: xi from `generator` in the same call, or the linspace row, so
a run's random stream is the same on either route. No gradient: the depths
are sampled, not differentiated.
"""

from lidarnerf_tpu_torch.models.occupancy import occ_draws, occ_z_vals, volume_bin_pdf
from lidarnerf_tpu_torch.ops import dispatch, occ_sample_cuda


def occ_sample_plain(occ3, rays_o, rays_d, nears, fars, cfg, bound: float, num_steps: int,
                     perturb: bool, xi=None, want_pdf=False, generator=None):
    """The plain PyTorch version: z [N, num_steps], or (z, pdf [N, bins])
    with `want_pdf`."""
    pdf = volume_bin_pdf(occ3, rays_o, rays_d, nears, fars, cfg, bound)
    z = occ_z_vals(nears, fars, pdf, num_steps, perturb, xi=xi, generator=generator)
    return (z, pdf) if want_pdf else z


def occ_sample(occ3, rays_o, rays_d, nears, fars, cfg, bound: float, num_steps: int,
               perturb: bool, xi=None, want_pdf=False, generator=None):
    """The `--fast` sampler; the kernel on CUDA tensors.

    occ3 [G, G, G] 0/1 (`occupied_volume`), rays_o, rays_d [N, 3], nears,
    fars [N, 1], `cfg` the OccConfig (bins, floor). With `perturb`, xi
    [N, num_steps] uniform [0, 1) (drawn from `generator` unless given),
    else the inclusive linspace. Returns z [N, num_steps], or (z, pdf
    [N, bins]) with `want_pdf`. Both routes take any floor in [0, 1] and
    any bin count (the kernel up to `occ_sample_cuda.MAX_BINS`).
    """
    if not (dispatch.uses_kernel(occ3) or dispatch.uses_kernel(rays_o)):
        return occ_sample_plain(occ3, rays_o, rays_d, nears, fars, cfg, bound, num_steps,
                                perturb, xi, want_pdf, generator)
    xi, u_row = occ_draws(rays_o.shape[0], num_steps, perturb, occ3.device, xi, generator)
    z, pdf = occ_sample_cuda.occ_sample(
        occ3.contiguous(), rays_o.contiguous(), rays_d.contiguous(), nears.contiguous(),
        fars.contiguous(), cfg.bins, num_steps, bound, cfg.floor,
        xi=None if xi is None else xi.contiguous(),
        u_row=None if u_row is None else u_row.contiguous(), want_pdf=want_pdf)
    return (z, pdf) if want_pdf else z
