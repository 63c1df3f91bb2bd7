"""Parameter utilities (counterpart of ``chunkformer_tpu/utils/params.py``).

``random_params_like`` fills a port module with the weights that the JAX
package's ``random_params_like(init_fn, seed, scale)`` draws for the same
model: N(0, 1) * scale in float32 from ``np.random.default_rng(seed)``, one
draw per leaf of the JAX parameter tree in its leaf order (batch-norm
running statistics and CMVN included, as the JAX tree holds them), carried
onto the port's names and layouts by ``convert.jax_layout``. Benches and
compile checks use it where the weights' values do not matter.
``count_params`` and ``tree_bytes`` count the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import jax_layout, jax_leaf_order


def _jax_tensors(model: torch.nn.Module):
    sd = model.state_dict()
    return sd, jax_layout(sd.keys())


@torch.no_grad()
def random_params_like(model: torch.nn.Module, seed: int = 0,
                       scale: float = 0.05) -> torch.nn.Module:
    """Overwrite ``model``'s weights in place with the JAX package's random
    draws for the same model; returns the model."""
    sd, layout = _jax_tensors(model)
    shapes = {}
    for name, (path, layer, transposed) in layout.items():
        shape = tuple(sd[name].shape)
        shape = shape[::-1] if transposed else shape
        if layer is not None:
            shape = (max(layer + 1, shapes.get(path, (0,))[0]),) + shape
        shapes[path] = shape
    rng = np.random.default_rng(seed)
    leaves = {path: (rng.standard_normal(shapes[path]) * scale).astype(np.float32)
              for path in jax_leaf_order(shapes)}
    for name, (path, layer, transposed) in layout.items():
        value = leaves[path] if layer is None else leaves[path][layer]
        sd[name].copy_(torch.from_numpy(np.ascontiguousarray(value.T if transposed else value)))
    return model


def count_params(model: torch.nn.Module) -> int:
    """Elements of the tensors the JAX parameter tree holds (``count_params``)."""
    sd, layout = _jax_tensors(model)
    return sum(sd[name].numel() for name in layout)


def tree_bytes(model: torch.nn.Module) -> int:
    """Bytes of the same tensors in their dtypes (``tree_bytes``)."""
    sd, layout = _jax_tensors(model)
    return sum(sd[name].numel() * sd[name].element_size() for name in layout)
