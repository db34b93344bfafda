"""Shared helpers for the tests of the PyTorch port (imports no JAX, so the
GPU-only tests can use it on a machine without JAX)."""
import numpy as np


def bf16_ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in bf16 ulps between two arrays whose values
    are bf16-representable (given as float32 or float64). Equal infinities
    are 0 apart; +0 and -0 are 0 apart."""
    def ordered(x):
        bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        mag = bits & 0x7FFF
        return np.where(bits & 0x8000, -mag, mag)

    return np.abs(ordered(a) - ordered(b))


def within_reorder_bound(q, kb, a, b) -> np.ndarray:
    """Whether two bf16 score matrices a, b of q @ kb.T (all as float32
    numpy) agree within what summation order allows: two float32 sums of
    the same d products differ by at most 2 g_d sum_i |q_i kb_i|
    (g_d = d u / (1 - d u), u = 2^-24), and rounding each to bf16 adds at
    most one bf16 ulp of the larger value. -inf must match -inf."""
    d = q.shape[1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    finite = np.isfinite(b)
    same_mask = finite == np.isfinite(a)
    a, b = np.where(finite, a, 0.0), np.where(finite, b, 0.0)
    diff = np.abs(a - b)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.ldexp(1.0, np.frexp(mag)[1] - 8)
    bound = 2 * gamma * (np.abs(q) @ np.abs(kb).T) + ulp
    return same_mask & (diff <= bound)


def bf16_bits(a) -> np.ndarray:
    """The uint16 bit patterns of a bf16 array: a torch tensor, or a numpy
    array of the 2-byte bfloat16 dtype that a JAX array converts to."""
    if hasattr(a, "detach"):
        import torch

        return a.detach().cpu().contiguous().view(torch.int16).numpy().view(
            np.uint16)
    a = np.asarray(a)
    assert a.dtype.itemsize == 2, a.dtype
    return a.view(np.uint16)


def device_bm25_arrays(dev) -> dict:
    """The built state of a DeviceBM25 (either package's) as numpy: bf16
    arrays as their uint16 bit patterns, the rest in their own dtypes."""
    def host(a):
        return a.detach().cpu().numpy() if hasattr(a, "detach") \
            else np.asarray(a)

    return {
        "head_dense": bf16_bits(dev.head_dense),
        "tail_w": bf16_bits(dev.tail_w),
        "tail_docs": host(dev.tail_docs),
        "head_pos": np.asarray(dev.head_pos),
        "tail_offsets": np.asarray(dev.tail_offsets),
        "l_mid": dev.l_mid, "l_small": dev.l_small, "d_pad": dev.d_pad,
    }


def jax_tree(module):
    """The JAX package's param tree (numpy f32 leaves) of a port module
    whose submodules are named as the tree's keys: the inverse of
    ``viquae_torch.models.convert.state_dict_from_tree``. Lets a test draw
    seeded weights with the port (fast) and hand the same weights to the
    JAX functions."""
    from torch import nn

    def arr(t):
        return t.detach().cpu().float().numpy().copy()

    def node(mod):
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = arr(mod.weight)
            out = {"kernel": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T}
            if mod.bias is not None:
                out["bias"] = arr(mod.bias)
            return out
        if hasattr(mod, "running_mean"):
            return {"scale": arr(mod.weight), "bias": arr(mod.bias),
                    "mean": arr(mod.running_mean),
                    "var": arr(mod.running_var)}
        if isinstance(mod, nn.LayerNorm):
            return {"scale": arr(mod.weight), "bias": arr(mod.bias)}
        if isinstance(mod, nn.PReLU):
            return {"alpha": arr(mod.weight)}
        if isinstance(mod, nn.ModuleList):
            return [node(child) for child in mod]
        out = {name: arr(p) for name, p in
               mod.named_parameters(recurse=False)}
        out.update({name: node(child) for name, child in
                    mod.named_children()})
        return out

    return node(module)


def randomize_batch_norm_(module, seed: int = 0):
    """Non-trivial batch-norm statistics (mean/var mix-ups must show):
    means and shifts U(-0.2, 0.2), variances and scales U(0.5, 1.5)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if hasattr(mod, "running_mean"):
                for t, (lo, hi) in ((mod.running_mean, (-0.2, 0.2)),
                                    (mod.bias, (-0.2, 0.2)),
                                    (mod.running_var, (0.5, 1.5)),
                                    (mod.weight, (0.5, 1.5))):
                    t.copy_(torch.rand(t.shape, generator=gen)
                            * (hi - lo) + lo)
    return module


def jax_layout(module, grads: bool = False) -> dict:
    """{JAX path: f32 numpy array} of a port module's parameters (or of
    their ``.grad`` with ``grads``) in the JAX package's layouts (dense
    kernels (in, out), convolution kernels HWIO, expert stacks as they
    are), keyed as
    ``jax.tree_util`` paths of the JAX param tree, so a test can compare
    leaf by leaf."""
    from viquae_torch.models.convert import jax_paths

    named = dict(module.named_parameters())
    out = {}
    for name, path in jax_paths(module).items():
        t = named[name].grad if grads else named[name]
        a = (np.zeros(tuple(named[name].shape), np.float32) if t is None
             else t.detach().cpu().float().numpy())
        if path.endswith("kernel") and a.ndim != 3:  # 3-D: expert stacks
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        out[path] = a
    return out


def flat_leaves(tree, prefix="") -> dict:
    """{"/"-joined path: numpy array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def perturbed(tree, seed: int = 0, scale: float = 0.05):
    """A copy of a param tree (numpy leaves) with N(0, scale) added to
    every leaf: zero biases, unit LayerNorm scales and zero gates of a
    fresh init would hide a mis-mapped or dropped tensor."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        a = np.asarray(node, np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)
