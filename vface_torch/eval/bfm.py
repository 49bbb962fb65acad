"""BFM09 morphable-model math and a vertex splat renderer (port of ``vface_tpu/eval/bfm.py``).

Deep3DFaceRecon's parametric face model and the qualitative overlays of the
expression eval, with no rasteriser:

* :func:`split_coeff`: the 257-d layout (id 80 / exp 64 / tex 80 / angle 3 /
  gamma 27 / trans 3);
* :func:`compute_shape` / :func:`compute_texture`: mean + basis . coeff;
* :func:`compute_rotation`: XYZ Euler angles (the BFM convention);
* :func:`sh_illumination`: 9-band spherical-harmonic shading per channel;
* :func:`vertex_normals`, :func:`project` (focal 1015, centre 112 at 224^2);
* :func:`splat_render`: z-buffered vertex splatting.

The BFM09 basis arrays are licensed assets the user supplies; every function
takes them as plain tensors. float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ID_DIM, EXP_DIM, TEX_DIM = 80, 64, 80


class BFMCoeffs(NamedTuple):
    id: torch.Tensor      # (B, 80)
    exp: torch.Tensor     # (B, 64)
    tex: torch.Tensor     # (B, 80)
    angle: torch.Tensor   # (B, 3)
    gamma: torch.Tensor   # (B, 27)
    trans: torch.Tensor   # (B, 3)


def split_coeff(coeffs: torch.Tensor) -> BFMCoeffs:
    return BFMCoeffs(id=coeffs[:, :80], exp=coeffs[:, 80:144], tex=coeffs[:, 144:224], angle=coeffs[:, 224:227],
                     gamma=coeffs[:, 227:254], trans=coeffs[:, 254:257])


def compute_shape(mean_shape, id_base, exp_base, id_coef, exp_coef) -> torch.Tensor:
    """(B, V, 3) vertices: mean + id_base . alpha + exp_base . beta."""
    b = id_coef.shape[0]
    v = mean_shape.reshape(-1, 3)
    return (v[None] + torch.einsum("vk,bk->bv", id_base, id_coef).reshape(b, -1, 3)
            + torch.einsum("vk,bk->bv", exp_base, exp_coef).reshape(b, -1, 3))


def compute_texture(mean_tex, tex_base, tex_coef) -> torch.Tensor:
    b = tex_coef.shape[0]
    return mean_tex.reshape(-1, 3)[None] + torch.einsum("vk,bk->bv", tex_base, tex_coef).reshape(b, -1, 3)


def compute_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(B, 3) XYZ Euler radians -> (B, 3, 3), the BFM convention (the transpose of Rz Ry Rx)."""
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx, cy, sy, cz, sz = torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y), torch.cos(z), torch.sin(z)
    o, zr = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([o, zr, zr, zr, cx, -sx, zr, sx, cx], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, zr, sy, zr, o, zr, -sy, zr, cy], -1).reshape(-1, 3, 3)
    rz = torch.stack([cz, -sz, zr, sz, cz, zr, zr, zr, o], -1).reshape(-1, 3, 3)
    return (rz @ ry @ rx).transpose(1, 2)


_SH_A = (math.pi, 2 * math.pi / math.sqrt(3.0), 2 * math.pi / math.sqrt(8.0))
_SH_C = (1 / math.sqrt(4 * math.pi), math.sqrt(3.0) / math.sqrt(4 * math.pi),
         3 * math.sqrt(5.0) / math.sqrt(12 * math.pi))


def sh_illumination(normals: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) normals and (B, 27) SH coefficients -> (B, V, 3) shading."""
    b = normals.shape[0]
    g = gamma.reshape(b, 3, 9).clone()
    g[:, :, 0] += 0.8
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    a0, a1, a2 = _SH_A
    c0, c1, c2 = _SH_C
    basis = torch.stack([a0 * c0 * torch.ones_like(nx), -a1 * c1 * ny, a1 * c1 * nz, -a1 * c1 * nx,
                         a2 * c2 * nx * ny, -a2 * c2 * ny * nz, 0.5 * a2 * c2 / math.sqrt(3.0) * (3 * nz**2 - 1),
                         -a2 * c2 * nx * nz, 0.5 * a2 * c2 * (nx**2 - ny**2)], dim=-1)
    return torch.einsum("bvk,bck->bvc", basis, g)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: verts (B, V, 3), faces (F, 3) integer."""
    faces = faces.long()
    v0, v1, v2 = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_add(1, faces[:, i], fn)
    return vn / (torch.linalg.vector_norm(vn, dim=-1, keepdim=True) + 1e-8)


def project(verts: torch.Tensor, focal: float = 1015.0, center: float = 112.0, cam_z: float = 10.0):
    """Perspective projection to 224^2 pixel coordinates (the reconstruction camera) -> (..., 3) x, y, depth."""
    z = cam_z - verts[..., 2]
    return torch.stack([focal * verts[..., 0] / z + center, center - focal * verts[..., 1] / z, z], dim=-1)


def splat_render(projected: torch.Tensor, colors: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Z-buffered vertex splat: projected (V, 3) x, y, depth; colors (V, 3) ->
    (size, size, 3). Each vertex lands on its nearest pixel; a pixel's depth
    is the minimum of its vertices' (a scatter-min), and the vertices within
    1e-6 of it own the pixel: its colour is their mean (vertices of equal
    depth share a pixel; empty pixels are 0)."""
    xi = torch.clamp(torch.round(projected[:, 0]), 0, size - 1).long()
    yi = torch.clamp(torch.round(projected[:, 1]), 0, size - 1).long()
    pix = yi * size + xi
    depth = projected[:, 2]
    zbuf = torch.full((size * size,), float("inf"), dtype=depth.dtype, device=depth.device)
    zbuf = zbuf.scatter_reduce(0, pix, depth, reduce="amin")
    owns = depth <= zbuf[pix] + 1e-6
    img = torch.zeros((size * size, 3), dtype=colors.dtype, device=colors.device)
    img = img.index_add(0, pix, torch.where(owns[:, None], colors, torch.zeros_like(colors)))
    wsum = torch.zeros((size * size, 1), dtype=colors.dtype, device=colors.device)
    wsum = wsum.index_add(0, pix, owns[:, None].to(colors.dtype))
    return (img / torch.clamp(wsum, min=1.0)).reshape(size, size, 3)


def render_coeffs(coeffs: torch.Tensor, mean_shape, id_base, exp_base, mean_tex, tex_base, faces,
                  size: int = 224) -> torch.Tensor:
    """The full reconstruction render of one coefficient vector (B = 1) -> (size, size, 3)."""
    c = split_coeff(coeffs)
    shape = compute_shape(mean_shape, id_base, exp_base, c.id, c.exp)
    verts = torch.einsum("bij,bvj->bvi", compute_rotation(c.angle), shape) + c.trans[:, None, :]
    tex = torch.clamp(compute_texture(mean_tex, tex_base, c.tex) / 255.0, 0.0, 1.0)
    color = torch.clamp(tex * sh_illumination(vertex_normals(verts, faces), c.gamma), 0.0, 1.0)
    return splat_render(project(verts)[0], color[0], size)
