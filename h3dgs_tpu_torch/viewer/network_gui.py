"""Remote-viewer protocol peer (counterpart of the socket and message parts
of ``h3dgs_tpu/viewer/network_gui.py``; byte-compatible with it).

A non-blocking TCP listener; messages are 4-byte-little-endian-length-
prefixed JSON carrying camera matrices and toggles; replies are raw RGB
bytes followed by a length-prefixed verify string. The protocol's
matrices arrive ROW-vector style (transposed relative to the column-vector
Camera) with Y/Z columns flipped. The training-loop ``poll`` comes with
the training slice.
"""
from __future__ import annotations

import json
import math
import socket
from typing import Optional

import numpy as np

from ..scene.camera import Camera, camera_from_arrays


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 model_path: str = ""):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.model_path = model_path

    def close(self) -> None:
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.conn = None

    def _try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nViewer connected by {addr}", flush=True)
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read_msg(self) -> dict:
        """Blocking read of one length-prefixed JSON message."""
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionResetError
            buf += chunk
        return buf

    def _send(self, image_bytes: Optional[bytes]):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        verify = self.model_path
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    @staticmethod
    def _camera_from_msg(m: dict) -> Optional[Camera]:
        w, h = m["resolution_x"], m["resolution_y"]
        if w == 0 or h == 0:
            return None
        view = np.asarray(m["view_matrix"], np.float32).reshape(4, 4)
        view[:, 1] = -view[:, 1]
        view[:, 2] = -view[:, 2]
        proj = np.asarray(m["view_projection_matrix"],
                          np.float32).reshape(4, 4)
        proj[:, 1] = -proj[:, 1]
        # The wire stores transposed (row-vector) matrices; ours act on
        # columns.
        view_t = view.T
        full_proj_t = proj.T
        return camera_from_arrays(
            view_t, full_proj_t, np.linalg.inv(view_t)[:3, 3],
            np.float32(math.tan(m["fov_x"] * 0.5)),
            np.float32(math.tan(m["fov_y"] * 0.5)), h, w)
