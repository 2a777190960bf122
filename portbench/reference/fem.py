"""Plain f64 total-Lagrangian TET10 finite elements in PyTorch: the
benchmark's reference for the port's answers.

Compressible neo-Hookean (Ciarlet form), with lam and mu:

    W = mu/2 (tr C - 3) - mu ln J + lam/2 (ln J)^2,   J^2 = det C
    S = mu (I - C^-1) + lam ln J C^-1,                 P = F S

The nodal internal force is f_a = sum_q w_q det(J_q) P_q g_a(q), with the
4-point degree-2 rule on the reference tetrahedron and quadratic shape
functions on the mesh's straight-edged tets. The tangent action K v is the
directional derivative of f at u along v, written out:

    dF = sum_a v_a (x) g_a,   dC = dF^T F + F^T dF,   dC^-1 = -C^-1 dC C^-1,
    d ln J = tr(C^-1 dC) / 2,  dS = -mu dC^-1 + lam (d ln J C^-1 + ln J dC^-1),
    dP = dF S + F dS.

Everything is computed in f64, element block by element block, on whatever
device the arrays are given on, and indexed by the half-grid of
`reference.mesh`. Nothing here knows of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.mesh import BoxMesh

#: elements per block: bounds the working set at ~0.2 GB in f64
BLOCK = 32768


def quadrature() -> tuple[np.ndarray, np.ndarray]:
    """The 4-point rule: natural coordinates [4, 3] and weights [4] (sum 1/6)."""
    a, b = (5 + 3 * math.sqrt(5)) / 20, (5 - math.sqrt(5)) / 20
    points = np.array([[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
    return points, np.full(4, 1.0 / 24.0)


def shape_gradients(points: np.ndarray) -> np.ndarray:
    """dN_a/dxi [q, 10, 3] of the TET10 shape functions at `points`:
    vertices N_i = L_i (2 L_i - 1), mid-edge nodes N_ij = 4 L_i L_j, with
    barycentric L = (1 - xi - eta - zeta, xi, eta, zeta)."""
    dL = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    out = []
    for p in points:
        L = np.array([1 - p.sum(), *p])
        rows = [(4 * L[i] - 1) * dL[i] for i in range(4)]
        rows += [4 * (L[j] * dL[i] + L[i] * dL[j])
                 for i, j in ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))]
        out.append(np.stack(rows))
    return np.stack(out)


def inv_det(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M^-1, det M) of [..., 3, 3] by cofactors."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    cof = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * cof[..., 0, 0] + b * cof[..., 1, 0] + c * cof[..., 2, 0]
    return cof / det[..., None, None], det


class Problem:
    """One box, material and set of Dirichlet conditions on a device.

    `bc` is the configuration's {"fix": [face, ...], "prescribe": [{"set":
    face, "component": "x" | "y" | "z", "value": v}, ...]}; a prescribed
    value is the displacement at load factor 1."""

    def __init__(self, mesh: BoxMesh, lam: float, mu: float, bc: dict, device):
        self.mesh, self.lam, self.mu, self.device = mesh, float(lam), float(mu), device
        self.bc = bc
        f64 = torch.float64
        self.conn = torch.as_tensor(mesh.conn, device=device)
        self.coords = torch.as_tensor(mesh.coords, dtype=f64, device=device)
        points, weights = quadrature()
        self.dN = torch.as_tensor(shape_gradients(points), dtype=f64, device=device)
        self.w = torch.as_tensor(weights, dtype=f64, device=device)
        free = np.repeat(mesh.present[:, None], 3, 1).astype(np.float64)
        values = np.zeros((mesh.n_points, 3))
        for face in bc.get("fix", ()):
            free[mesh.face(face)] = 0.0
        for spec in bc.get("prescribe", ()):
            nodes, comp = mesh.face(spec["set"]), "xyz".index(spec["component"])
            free[nodes, comp] = 0.0
            values[nodes, comp] = spec["value"]
        self.free = torch.as_tensor(free, device=device)
        self.values = torch.as_tensor(values, device=device)
        self.prescribed = torch.as_tensor(np.repeat(mesh.present[:, None], 3, 1), device=device) \
            & (self.free == 0.0)

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.mesh.n_points, 3), dtype=torch.float64, device=self.device)

    def affine_start(self, scale: float) -> torch.Tensor:
        """bench.py's start: the field that runs linearly from 0 to each
        prescribed value along the axis of its face (u_c = scale * v *
        x_axis / length for a value v on a max face), on the nodes."""
        u = self.zeros()
        for spec in self.bc.get("prescribe", ()):
            axis, comp = "xyz".index(spec["set"][0]), "xyz".index(spec["component"])
            u[:, comp] += scale * spec["value"] * self.coords[:, axis] / self.mesh.length
        return u * torch.as_tensor(self.mesh.present[:, None], device=self.device)

    def impose(self, u: torch.Tensor, scale: float) -> torch.Tensor:
        """u with its prescribed entries set to scale * value."""
        return self.free * u + (1.0 - self.free) * (scale * self.values)

    def _blocks(self):
        for s in range(0, self.conn.shape[0], BLOCK):
            conn = self.conn[s:s + BLOCK]
            X = self.coords[conn]  # [B, 10, 3]
            J = torch.einsum("bai,qad->bqid", X, self.dN)
            Jinv, detJ = inv_det(J)
            G = torch.einsum("qad,bqdj->bqaj", self.dN, Jinv)  # [B, q, 10, 3]
            yield conn, G, detJ * self.w

    def _state(self, conn, G, u):
        eye = torch.eye(3, dtype=u.dtype, device=u.device)
        F = eye + torch.einsum("bai,bqaj->bqij", u[conn], G)
        C = F.transpose(-1, -2) @ F
        Cinv, detC = inv_det(C)
        lnJ = 0.5 * torch.log(detC)[..., None, None]
        S = self.mu * (eye - Cinv) + self.lam * lnJ * Cinv
        return F, S, Cinv, lnJ

    def _scatter(self, out, conn, wdet, P, G):
        fe = torch.einsum("bq,bqij,bqaj->bai", wdet, P, G)
        out.index_add_(0, conn.reshape(-1), fe.reshape(-1, 3))

    def internal_force(self, u: torch.Tensor) -> torch.Tensor:
        """f_int [(2n+1)^3, 3] at u [(2n+1)^3, 3]."""
        out = self.zeros()
        for conn, G, wdet in self._blocks():
            F, S, _, _ = self._state(conn, G, u)
            self._scatter(out, conn, wdet, F @ S, G)
        return out

    def tangent_apply(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """K(u) v [(2n+1)^3, 3]: the derivative of f_int at u along v."""
        out = self.zeros()
        for conn, G, wdet in self._blocks():
            F, S, Cinv, lnJ = self._state(conn, G, u)
            dF = torch.einsum("bai,bqaj->bqij", v[conn], G)
            dC = dF.transpose(-1, -2) @ F + F.transpose(-1, -2) @ dF
            dCinv = -Cinv @ dC @ Cinv
            dlnJ = 0.5 * (Cinv * dC.transpose(-1, -2)).sum((-2, -1))[..., None, None]
            dS = -self.mu * dCinv + self.lam * (dlnJ * Cinv + lnJ * dCinv)
            self._scatter(out, conn, wdet, dF @ S + F @ dS, G)
        return out

    def residual(self, u: torch.Tensor) -> torch.Tensor:
        """R = M (f_ext - f_int(u)) with no external load: [(2n+1)^3, 3]."""
        return -self.free * self.internal_force(u)
