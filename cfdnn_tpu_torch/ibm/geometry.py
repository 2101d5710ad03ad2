"""Signed-distance-function bodies for the immersed-boundary method (the
port's own copy of `cfdnn_tpu/ibm/geometry.py`, which imports only NumPy).

The same five analytic bodies as the reference C++ code's geometry layer
(include/ibm_geometry.hpp:17-120, src/ibm_geometry.cpp) -- cylinder,
sphere, 4-digit NACA airfoil, forward- and backward-facing step, Breuer
periodic hills -- with vectorized NumPy `phi` evaluated once on the host at
set-up; `ibm.forcing.IBMForcing` turns them into device weight masks.

Convention: phi < 0 inside the body, phi > 0 outside, phi = 0 on the surface.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class IBMBody:
    """Base: vectorized SDF over broadcastable (x, y, z) arrays."""

    name = "body"

    def phi(self, x, y, z):
        raise NotImplementedError

    def normal(self, x, y, z, eps: float = 1e-6):
        """Outward unit normal via central-difference gradient of phi
        (reference IBMBody::normal default)."""
        gx = (self.phi(x + eps, y, z) - self.phi(x - eps, y, z)) / (2 * eps)
        gy = (self.phi(x, y + eps, z) - self.phi(x, y - eps, z)) / (2 * eps)
        gz = (self.phi(x, y, z + eps) - self.phi(x, y, z - eps)) / (2 * eps)
        n = np.sqrt(gx**2 + gy**2 + gz**2)
        n = np.where(n < 1e-12, 1.0, n)
        return gx / n, gy / n, gz / n

    def closest_point(self, x, y, z):
        """x - phi * normal (reference IBMBody::closest_point default)."""
        p = self.phi(x, y, z)
        nx, ny, nz = self.normal(x, y, z)
        return x - p * nx, y - p * ny, z - p * nz


@dataclasses.dataclass
class CylinderBody(IBMBody):
    """Infinite z-aligned cylinder (reference ibm_geometry.hpp:36-50)."""

    cx: float
    cy: float
    radius: float
    name = "Cylinder"

    def phi(self, x, y, z):
        return np.sqrt((x - self.cx) ** 2 + (y - self.cy) ** 2) - self.radius


@dataclasses.dataclass
class SphereBody(IBMBody):
    """Sphere (reference ibm_geometry.hpp:52-64)."""

    cx: float
    cy: float
    cz: float
    radius: float
    name = "Sphere"

    def phi(self, x, y, z):
        return np.sqrt((x - self.cx) ** 2 + (y - self.cy) ** 2
                       + (z - self.cz) ** 2) - self.radius


@dataclasses.dataclass
class NACABody(IBMBody):
    """4-digit NACA airfoil extruded in z (reference ibm_geometry.hpp:66-89).

    Approximate SDF: vertical distance to the camber +/- thickness envelope
    within the chord, combined with the chordwise distance beyond LE/TE by
    the standard box-combination rule.
    """

    x_le: float
    y_le: float
    chord: float
    aoa: float            # radians
    digits: str = "0012"

    def __post_init__(self):
        d = self.digits
        self.max_camber = int(d[0]) / 100.0
        self.camber_pos = max(int(d[1]) / 10.0, 1e-6)
        self.thickness = int(d[2:4]) / 100.0
        self.name = f"NACA{d}"

    def _thickness_at(self, xn):
        t = self.thickness
        return 5.0 * t * (0.2969 * np.sqrt(np.maximum(xn, 0.0))
                          - 0.1260 * xn - 0.3516 * xn**2
                          + 0.2843 * xn**3 - 0.1036 * xn**4)

    def _camber_at(self, xn):
        m, p = self.max_camber, self.camber_pos
        if m == 0.0:
            return np.zeros_like(xn)
        fore = m / p**2 * (2 * p * xn - xn**2)
        aft = m / (1 - p) ** 2 * ((1 - 2 * p) + 2 * p * xn - xn**2)
        return np.where(xn < p, fore, aft)

    def phi(self, x, y, z):
        # aerodynamic convention: positive aoa pitches the nose UP for
        # flow in +x (trailing edge below the leading edge), so positive
        # aoa -> positive lift (world->body rotation by +aoa)
        ca, sa = np.cos(self.aoa), np.sin(self.aoa)
        dx, dy = x - self.x_le, y - self.y_le
        xb = (ca * dx - sa * dy) / self.chord
        yb = (sa * dx + ca * dy) / self.chord
        xn = np.clip(xb, 0.0, 1.0)
        yc = self._camber_at(xn)
        yt = self._thickness_at(xn)
        dyc = yb - yc
        d_y = np.maximum(dyc - yt, -(dyc + yt))
        d_x = np.maximum(-xb, xb - 1.0)
        inside = (d_y < 0.0) & (d_x < 0.0)
        both_out = (d_y >= 0.0) & (d_x >= 0.0)
        d = np.where(inside, np.maximum(d_y, d_x),
                     np.where(both_out, np.sqrt(d_y**2 + d_x**2),
                              np.maximum(d_y, d_x)))
        return d * self.chord + 0.0 * np.asarray(z)


@dataclasses.dataclass
class StepBody(IBMBody):
    """Forward/backward-facing step: solid {x >= x_step, y <= y_step}
    (reference ibm_geometry.hpp:91-103). Exact SDF of the quadrant."""

    x_step: float
    y_step: float
    name = "Step"

    def phi(self, x, y, z):
        dx = self.x_step - x          # >0 left of the step face
        dy = y - self.y_step          # >0 above the step top
        outside_corner = (dx > 0) & (dy > 0)
        inside = (dx <= 0) & (dy <= 0)
        d = np.where(
            inside, -np.minimum(-dx, -dy),
            np.where(outside_corner, np.sqrt(dx**2 + dy**2),
                     np.maximum(np.minimum(dx, np.inf) * (dx > 0),
                                np.minimum(dy, np.inf) * (dy > 0))))
        # the non-corner outside regions: distance is whichever of dx/dy > 0
        d = np.where(inside, d,
                     np.where(outside_corner, np.sqrt(dx**2 + dy**2),
                              np.where(dx > 0, dx, dy)))
        return d + 0.0 * np.asarray(z)


@dataclasses.dataclass
class BackwardStepBody(IBMBody):
    """Backward-facing step: solid {x <= x_step, y <= y_step} — the inlet
    floor that drops away (sudden expansion). Mirror image of StepBody;
    exact SDF of the quadrant. Used by the Armaly et al. (1983) laminar
    reattachment-length validation (apps/step.py --backward)."""

    x_step: float
    y_step: float
    name = "BackwardStep"

    def phi(self, x, y, z):
        dx = x - self.x_step          # >0 right of the step face
        dy = y - self.y_step          # >0 above the step top
        outside_corner = (dx > 0) & (dy > 0)
        inside = (dx <= 0) & (dy <= 0)
        d = np.where(inside, np.maximum(dx, dy),     # negative inside
                     np.where(outside_corner, np.sqrt(dx**2 + dy**2),
                              np.where(dx > 0, dx, dy)))
        return d + 0.0 * np.asarray(z)


@dataclasses.dataclass
class PeriodicHillBody(IBMBody):
    """Breuer et al. 2009 periodic hills (ERCOFTAC UFR 3-30): 6 piecewise
    cubics over the hill, period 9h, mirrored descending side (reference
    ibm_geometry.hpp:105-118, src/ibm_geometry.cpp hill_profile_normalized).
    Approximate SDF = vertical distance to the profile (adequate inside the
    forcing band)."""

    h: float
    name = "PeriodicHills"

    def _profile_normalized(self, xn):
        """Hill height y/h for x/h in [0, 1.929] (published benchmark
        polynomial fit of the hill shape)."""
        xn = np.asarray(xn)
        v = np.where(
            xn <= 0.3214,
            np.minimum(1.0, 1.0 + 0.18973 * xn**2 - 1.66518 * xn**3),
            np.where(
                xn <= 0.5,
                0.8955 + 0.97552 * xn - 2.84514 * xn**2 + 1.48159 * xn**3,
                np.where(
                    xn <= 0.7143,
                    0.9213 + 0.82068 * xn - 2.53546 * xn**2 + 1.27499 * xn**3,
                    np.where(
                        xn <= 1.071,
                        1.445 - 1.37956 * xn + 0.54488 * xn**2 - 0.16231 * xn**3,
                        np.where(
                            xn <= 1.429,
                            0.6401 + 0.87444 * xn - 1.55859 * xn**2
                            + 0.49216 * xn**3,
                            np.maximum(0.0, 2.0139 - 2.01040 * xn
                                       + 0.46060 * xn**2 + 0.02097 * xn**3),
                        )))))
        return np.where(xn >= 1.929, 0.0, v)

    def hill_height(self, x):
        xn = np.mod(np.asarray(x) / self.h, 9.0)
        asc = self._profile_normalized(xn)
        desc = self._profile_normalized(9.0 - xn)
        return self.h * np.where(xn <= 1.929, asc,
                                 np.where(xn >= 7.071, desc, 0.0))

    def phi(self, x, y, z):
        return y - self.hill_height(x) + 0.0 * np.asarray(z)


def create_ibm_body(kind: str, **kw) -> IBMBody:
    """Factory (reference create_ibm_body, ibm_geometry.hpp:120+)."""
    kind = kind.lower()
    if kind == "cylinder":
        return CylinderBody(kw["cx"], kw["cy"], kw["radius"])
    if kind == "sphere":
        return SphereBody(kw["cx"], kw["cy"], kw.get("cz", 0.0), kw["radius"])
    if kind in ("naca", "airfoil"):
        return NACABody(kw["x_le"], kw["y_le"], kw["chord"],
                        kw.get("aoa", 0.0), kw.get("digits", "0012"))
    if kind == "step":
        return StepBody(kw["x_step"], kw["y_step"])
    if kind in ("backward_step", "bfs"):
        return BackwardStepBody(kw["x_step"], kw["y_step"])
    if kind in ("hills", "periodic_hills"):
        return PeriodicHillBody(kw["h"])
    raise ValueError(f"unknown IBM body '{kind}'")
