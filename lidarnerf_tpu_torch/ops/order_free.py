"""Order-free row accumulation: a scatter-add whose sum repeats bit for bit.

The table gradients of the hash grid (`ops/hash_grid.py`) and the periodic
volume (`ops/periodic_volume.py`) add one term per (query, corner) into the
table's rows. A float32 `index_add_` on CUDA adds them with atomics in an
order that changes from run to run, and float32 addition is not associative.
So, as the block-hash backwards do (`csrc/block_hash_scatter.cuh:1-28`), each
term is rounded once to a fixed point, round(t * 2^k) to int64, and added
with an integer `index_add_`, whose sum does not depend on the order; the
sum is converted back at the end. The result is the same on every run and
on both devices.

k comes from the call's inputs on the device, with no host read, so the
step stays capturable in a CUDA graph: M = max |g| over the finite entries
of the incoming gradient bounds every term |w g| (the interpolation weights
lie in [0, 1]), and an entry sums at most `n_terms` of them. With
n_terms < 2^qb and M < 2^(e+1), k = 60 - e - qb keeps every sum below 2^61
(a factor 2 for the rounding of the terms). A non-finite term (a NaN or an
Inf in g) cannot be rounded to an integer: it goes through a float32
`index_add_` of its own, beside zeros for the finite terms. A sum of
non-finite values and zeros does not depend on the order either (any NaN
gives NaN, +Inf and -Inf give NaN, else the one infinity), so an entry is
non-finite exactly where one of its terms is, as in the JAX package's
scatter-add. One code path serves both devices; no TPU kernel stands
behind it (the JAX package's table gradient is XLA's scatter-add).
"""

import torch


def max_abs_finite(g):
    """max |g| over the finite entries of g, a 0-d float32 tensor on g's device."""
    return torch.where(torch.isfinite(g), g.abs(), 0.0).amax().float()


def fixed_point_scale(max_abs, n_terms):
    """2^k, a 0-d float64 tensor on max_abs's device: the fixed point at which
    `n_terms` terms of magnitude at most `max_abs` sum below 2^61."""
    qb = int(n_terms).bit_length()  # n_terms < 2^qb
    e = torch.frexp(max_abs).exponent.long() - 1  # max_abs < 2^(e + 1)
    return torch.exp2((60 - e - qb).double())


class RowAccumulator:
    """Sums [N, C] float32 terms into the rows of an [n_rows, C] table, order-free.

    add(rows, terms) any number of times with the one `scale`, then result().
    """

    def __init__(self, n_rows, width, scale):
        dev = scale.device
        self.scale = scale
        self.fixed = torch.zeros((n_rows, width), dtype=torch.int64, device=dev)
        self.nonfinite = torch.zeros((n_rows, width), dtype=torch.float32, device=dev)

    def add(self, rows, terms):
        finite = torch.isfinite(terms)
        fixed = torch.round(torch.where(finite, terms, 0.0).double() * self.scale)
        self.fixed.index_add_(0, rows, fixed.long())
        self.nonfinite.index_add_(0, rows, torch.where(finite, 0.0, terms))

    def result(self):
        """The float32 [n_rows, C] sums."""
        return self.nonfinite + (self.fixed.double() / self.scale).float()


class GatherRows(torch.autograd.Function):
    """table[rows] ([..] rows -> [.., C]), whose table gradient adds order-free
    (an entry sums at most every gathered row's gradient)."""

    @staticmethod
    def forward(ctx, table, rows):
        ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return table[rows]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        g = g.float().reshape(-1, g.shape[-1])
        acc = RowAccumulator(ctx.n_rows, g.shape[-1],
                             fixed_point_scale(max_abs_finite(g), max(rows.numel(), 1)))
        acc.add(rows.reshape(-1), g)
        return acc.result(), None


def gather_rows(table, rows):
    return GatherRows.apply(table, rows)
