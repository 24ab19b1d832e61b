"""3-vector helpers (rs_ray_toy_tpu/core/vec.py).

Two forms: componentwise helpers on (x, y, z) tensors (`rsqrt`, `dot3`,
`div`), which the kernels' plain versions use expression by expression,
and batched helpers on (N, 3) tensors for the wavefront loop.  1 / sqrt
stands for every reciprocal square root.
"""

import torch


def rsqrt(x):
    return 1.0 / torch.sqrt(x)


def div(a, b):
    """a / b rounded once, as a kernel's division is, on every device:
    with a python number on either side PyTorch computes a tensor times
    the number's reciprocal on a card (and reciprocal(b) * a for a
    number over a tensor everywhere), which differs from a / b in the
    last bit on about a fifth of the values.  The number is made a tensor
    first."""
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    elif not torch.is_tensor(a):
        a = torch.full_like(b, a)
    return a / b


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def dot(a, b):
    """Dot product over the trailing axis of (..., 3) tensors."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sum3(v):
    """v[..., 0] + v[..., 1] + v[..., 2], left to right on every device: a
    torch sum over the last axis associates its terms one way on the CPU
    and another on a card, and a last-bit difference can grow into a
    different path."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def norm3(v):
    """|v| over the trailing axis of (..., 3), summed as sum3."""
    return torch.sqrt(sum3(v * v))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def faceforward(n, v):
    """Flip n into the hemisphere of v (geometry.rs:1381)."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v1):
    """Orthonormal basis (v2, v3) around the unit vector v1, branching on
    |x| > |y| as the reference does (geometry.rs vec3_coordinate_system)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    zero = torch.zeros_like(x)
    v2 = torch.where(
        use_x[..., None],
        torch.stack([-z, zero, x], dim=-1) * inv_a[..., None],
        torch.stack([zero, z, -y], dim=-1) * inv_a[..., None],
    )
    return v2, cross(v1, v2)
