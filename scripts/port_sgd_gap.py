"""How far the PyTorch port's float32 SGD steps lie from the JAX package's
steps in float32 and in float64, on the CPU, beside how far the JAX
package's own float32 steps lie from its float64 ones: the measurement
behind the bars of the port's SGD tests, through the same helpers
(`tests/torch_port_util.py`: `sgd_steps`, `worst_ratio`,
`movement_gaps`).

    python scripts/port_sgd_gap.py lednet --batch 4 [--low-res] [--steps 1]
    python scripts/port_sgd_gap.py contextnet --width 96 --aux [--low-res]

Both packages start from the JAX model's float32 draw (the float64 run from
it cast) and take `--steps` SGD steps (lr 0.002, dropout at rate 0) on
the same random batches of (batch, 64, width) images with 5 classes, plain
CE or, with `--low-res`, `upsample_logits=False` and the resize CE; with
`--aux`, the model's aux heads too, through `aux_weighted_loss` (aux
weight 0.4). It prints each step's relative loss gaps; after the last
step the worst parameter or BN statistic of each pair as a multiple of the
rtol = atol = 1e-4 bar, and the parameters' movement from the start off
JAX float64's, as a relative L2 norm. This script imports JAX; the port
does not."""

from __future__ import annotations

import argparse
import functools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
for _name in ("ERFNET", "ESNET", "LEDNET", "CONTEXTNET"):
    os.environ.setdefault(f"TPU_SEG_PACKED_{_name}", "0")
    os.environ.setdefault(f"TPU_SEG_PACKED_{_name}_BODY", "0")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

from torch_port_util import (  # noqa: E402
    jax_model_at, jax_x64, movement_gaps, sgd_steps, worst_ratio)
from torch_semantic_segmentation_tpu import losses as jlosses  # noqa: E402
from torch_semantic_segmentation_tpu.models import (  # noqa: E402
    get_model as jax_model)
from torch_semantic_segmentation_tpu_torch import losses as tlosses  # noqa: E402
from torch_semantic_segmentation_tpu_torch.models import get_model  # noqa: E402
from torch_semantic_segmentation_tpu_torch.ops.dropout import Dropout  # noqa: E402

C = 5


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--low-res", action="store_true")
    p.add_argument("--aux", action="store_true")
    a = p.parse_args()
    torch.set_num_threads(2)
    kw = {"upsample_logits": False} if a.low_res else {}
    loss = ("resize_cross_entropy_loss" if a.low_res
            else "cross_entropy_loss")
    jloss, tloss = getattr(jlosses, loss), getattr(tlosses, loss)
    if a.aux:
        kw["aux"] = True
        jloss = functools.partial(jlosses.aux_weighted_loss, loss_fn=jloss,
                                  aux_weight=0.4)
        tloss = functools.partial(tlosses.aux_weighted_loss, loss_fn=tloss,
                                  aux_weight=0.4)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(a.steps):
        x = rng.normal(size=(a.batch, 64, a.width, 3)).astype(np.float32)
        y = rng.integers(0, C, (a.batch, 64, a.width)).astype(np.int32)
        y[:, :4, :9] = 255
        batches.append((x, y))

    def port():
        t = get_model(a.model, C, device="cpu", **kw)
        for m in t.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        return t

    j = jax_model(a.model, C, rngs=nnx.Rngs(0), **kw)
    for _, m in nnx.iter_graph(j):
        if isinstance(m, nnx.Dropout):
            m.rate = 0.0
    with jax_x64():
        r32 = sgd_steps(jax_model_at(j, jnp.float32), port(), jloss, tloss,
                        batches)
        r64 = sgd_steps(jax_model_at(j, jnp.float64), port(), jloss, tloss,
                        batches)
    j32 = dict(r64, port=r32["jax"])
    print(f"{a.model} {kw} batch {a.batch} 64x{a.width}, {a.steps} steps")
    for i, ((b32, a32), (_, a64)) in enumerate(
            zip(r32["losses"], r64["losses"]), start=1):
        print(f"step {i}: loss port32 {b32:.7f} jax32 {a32:.7f} jax64 "
              f"{a64:.7f}; relative gaps port32-jax32 "
              f"{abs(b32 - a32) / abs(a32):.3g}, port32-jax64 "
              f"{abs(b32 - a64) / abs(a64):.3g}, jax32-jax64 "
              f"{abs(a32 - a64) / abs(a64):.3g}")
    print(f"after {a.steps} steps, worst parameter or BN statistic over the "
          f"1e-4 bar: port32-jax32 {worst_ratio(r32['port'], r32['jax']):.3g}"
          f", port32-jax64 {worst_ratio(r64['port'], r64['jax']):.3g}, "
          f"jax32-jax64 {worst_ratio(r32['jax'], r64['jax']):.3g}")
    for name, run in (("port32", r64), ("jax32", j32)):
        print(f"movement off jax64's, relative L2, {name}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in movement_gaps(run).items()))


if __name__ == "__main__":
    main()
