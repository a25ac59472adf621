"""Pinhole FPS camera (the counterpart of ``spt_tpu.camera``).

The host-side state machine is numpy, copied from the JAX package: yaw/pitch
from position/target (Camera.cpp:19-27), basis rebuild (:32-50), WASD
movement (:52-72), mouse look with the ±89° pitch clamp (:74-88), and the
movement detection that resets progressive accumulation (:113-137).

The device side is :class:`CameraRays`, whose ``ray_directions_v`` matches
Camera::getRayDirection (:95-106): x,y in [0,1]² -> [-1,1]² with Y flip ->
normalized (forward + x·hw·right + y·hh·up).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spt_tpu_torch.ops import vec3 as v3

FORWARD, BACKWARD, LEFT, RIGHT = 0, 1, 2, 3


class CameraRays(NamedTuple):
    """Device camera basis: float32 tensors on the render device."""

    position: torch.Tensor    # (3,)
    forward: torch.Tensor     # (3,)
    right: torch.Tensor       # (3,)
    up: torch.Tensor          # (3,)
    half_width: torch.Tensor  # ()
    half_height: torch.Tensor # ()

    def ray_directions_v(self, x: torch.Tensor, y: torch.Tensor) -> v3.Vec3:
        """x, y in [0,1] (N,) -> normalized world directions as a Vec3."""
        nx = (x - 0.5) * 2.0
        ny = -(y - 0.5) * 2.0
        hw, hh = self.half_width, self.half_height
        d = v3.Vec3(
            self.forward[0] + nx * (hw * self.right[0]) + ny * (hh * self.up[0]),
            self.forward[1] + nx * (hw * self.right[1]) + ny * (hh * self.up[1]),
            self.forward[2] + nx * (hw * self.right[2]) + ny * (hh * self.up[2]),
        )
        return v3.safe_normalize(d)


class Camera:
    """Interactive host camera. All mutation happens host-side; `.rays()`
    snapshots the basis onto a device."""

    def __init__(
        self,
        position=(0.0, 3.0, 8.0),
        target=(0.0, 1.0, 0.0),
        up=(0.0, 1.0, 0.0),
        fov_degrees: float = 60.0,
        aspect_ratio: float = 800.0 / 600.0,
    ):
        self.position = np.asarray(position, np.float64)
        self.world_up = np.asarray(up, np.float64)
        self.fov = float(fov_degrees)
        self.aspect_ratio = float(aspect_ratio)
        self.movement_speed = 2.5
        self.mouse_sensitivity = 0.1

        direction = np.asarray(target, np.float64) - self.position
        direction = direction / np.linalg.norm(direction)
        self.yaw = float(np.degrees(np.arctan2(direction[2], direction[0])))
        self.pitch = float(np.degrees(np.arcsin(np.clip(direction[1], -1.0, 1.0))))

        self._last_position = self.position.copy()
        self._last_yaw = self.yaw
        self._last_pitch = self.pitch
        self._first_movement_check = True
        self._update_vectors()

    def _update_vectors(self) -> None:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        front = np.array([cy * cp, sp, sy * cp])
        self.forward = front / np.linalg.norm(front)
        right = np.cross(self.forward, np.array([0.0, 1.0, 0.0]))
        self.right = right / np.linalg.norm(right)
        cup = np.cross(self.right, self.forward)
        self.up = cup / np.linalg.norm(cup)
        self.half_height = float(np.tan(np.radians(self.fov) * 0.5))
        self.half_width = self.half_height * self.aspect_ratio

    # --- controls (Camera.cpp:52-88) -----------------------------------------

    def process_keyboard(self, direction: int, delta_time: float) -> None:
        v = self.movement_speed * delta_time
        if direction == FORWARD:
            self.position = self.position + self.forward * v
        elif direction == BACKWARD:
            self.position = self.position - self.forward * v
        elif direction == LEFT:
            self.position = self.position - self.right * v
        elif direction == RIGHT:
            self.position = self.position + self.right * v

    def process_mouse(self, dx: float, dy: float, constrain_pitch: bool = True) -> None:
        self.yaw += dx * self.mouse_sensitivity
        self.pitch += dy * self.mouse_sensitivity
        if constrain_pitch:
            self.pitch = float(np.clip(self.pitch, -89.0, 89.0))
        self._update_vectors()

    def set_position(self, position) -> None:
        self.position = np.asarray(position, np.float64)

    def set_aspect_ratio(self, aspect: float) -> None:
        self.aspect_ratio = float(aspect)
        self._update_vectors()

    # --- accumulation-reset detection (Camera.cpp:113-137) -------------------

    def has_moved_since_last_check(
        self, position_threshold: float = 0.001, rotation_threshold: float = 0.1
    ) -> bool:
        if self._first_movement_check:
            self._first_movement_check = False
            return True
        moved = (
            np.linalg.norm(self.position - self._last_position) > position_threshold
            or abs(self.yaw - self._last_yaw) > rotation_threshold
            or abs(self.pitch - self._last_pitch) > rotation_threshold
        )
        if moved:
            self._last_position = self.position.copy()
            self._last_yaw = self.yaw
            self._last_pitch = self.pitch
        return moved

    def reset_movement_tracking(self) -> None:
        self._last_position = self.position.copy()
        self._last_yaw = self.yaw
        self._last_pitch = self.pitch
        self._first_movement_check = False

    # --- device snapshot ------------------------------------------------------

    def rays(self, device) -> CameraRays:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return CameraRays(
            position=f32(self.position),
            forward=f32(self.forward),
            right=f32(self.right),
            up=f32(self.up),
            half_width=f32(self.half_width),
            half_height=f32(self.half_height),
        )


def default_camera(width: int = 800, height: int = 600) -> Camera:
    """The reference's setupCamera (main.cpp:97-103): pos (0,3,8), target
    (0,1,0), fov 60°."""
    return Camera(
        position=(0.0, 3.0, 8.0),
        target=(0.0, 1.0, 0.0),
        fov_degrees=60.0,
        aspect_ratio=width / height,
    )
