"""The bars of the port's spatial-sharding tests on the CPU
(`tests/test_torch_spatial_step.py`, `tests/test_torch_spatial_grad.py`,
`tests/test_torch_spatial_zoo_step.py`), and their helpers."""

import numpy as np
import torch

# The float32 gradient over the parameter tree, relative L2. Its readings
# against the JAX package's float64 gradient take one of two values: 1.8e-5,
# or 6.3e-3 where the sums' order flips the sign of one FFM output within
# float32 rounding of 0, and its ReLU's gradient with it (the single
# process takes either by its thread count, the bands by their split). A
# band's halo rows whose gradient is not sent back read 0.89, a PPM pool
# without the backward of its sum over bands 0.36: the bar sits between,
# 8x above the flip and 7x under the nearest fault.
GRAD_TREE_TOL = 0.05
# the classifier's gradients lie past that ReLU: their readings are 3e-6
HEAD_GRAD_TOL = 1e-4
HEAD = ("classifier.ds1", "classifier.ds2", "classifier.conv")
# the loss: readings equal, or 1 float32 step apart
LOSS_RTOL = 1e-6


def ranks_bands(ranks: list, key, part: str, data: int) -> torch.Tensor:
    """The global tensor from the ranks' bands: rank d·S + s holds data
    row d's band s, along dim 0 and dim 1."""
    spatial = len(ranks) // data
    rows = [torch.cat([ranks[d * spatial + s][key][part]
                       for s in range(spatial)], dim=1)
            for d in range(data)]
    return torch.cat(rows, dim=0)


def rel_tree(got: dict, want: dict, keys) -> float:
    """‖got − want‖ / ‖want‖ over the tensors `keys` of two dicts."""
    d = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
            for k in keys)
    m = sum(float((want[k].double() ** 2).sum()) for k in keys)
    return (d / m) ** 0.5


def check_loss_and_gradients(got: dict, loss, grads: dict, head=HEAD,
                             loss_rtol: float = LOSS_RTOL,
                             head_tol: float = HEAD_GRAD_TOL) -> None:
    """A rank's {"loss", "grads"} against a reference loss and gradient:
    the loss at `loss_rtol` (LOSS_RTOL), the tree at GRAD_TREE_TOL, the
    classifier (the parameters whose names start with `head`, FastSCNN's
    by default) at `head_tol` (HEAD_GRAD_TOL)."""
    keys = list(grads)
    head = [k for k in keys if k.startswith(head)]
    assert head
    np.testing.assert_allclose(float(got["loss"]), float(loss),
                               rtol=loss_rtol)
    tree = rel_tree(got["grads"], grads, keys)
    assert tree <= GRAD_TREE_TOL, tree
    gap = rel_tree(got["grads"], grads, head)
    assert gap <= head_tol, gap
