"""Remote-viewer protocol peer (counterpart of the socket and message parts
of ``h3dgs_tpu/viewer/network_gui.py``; byte-compatible with it).

A non-blocking TCP listener; messages are 4-byte-little-endian-length-
prefixed JSON carrying camera matrices and toggles; replies are raw RGB
bytes followed by a length-prefixed verify string. The protocol's
matrices arrive ROW-vector style (transposed relative to the column-vector
Camera) with Y/Z columns flipped. ``poll`` serves the viewer from the
training loop.
"""
from __future__ import annotations

import json
import math
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch

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
        self.keep_alive = False

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

    def _try_read_msg(self):
        """One message, or None if none is pending. Only the first byte is
        probed without blocking; the rest of a started message is read
        with a timeout, so the length-prefixed stream never desyncs."""
        self.conn.settimeout(0)
        try:
            first = self.conn.recv(1)
        except (BlockingIOError, socket.timeout):
            return None
        finally:
            self.conn.settimeout(10.0)
        if not first:
            raise ConnectionResetError
        n = int.from_bytes(first + self._recv_exact(3), "little")
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

    def poll(self, state, sh_degree: int, raster_cfg, bg) -> None:
        """Serve any pending viewer request; called from the train loop.

        While the viewer has training paused (train=false), this blocks
        in this call serving frames, as the reference's receive loop does. Frames
        are rendered with ``render_for_training`` under ``no_grad``."""
        if self.conn is None:
            self._try_connect()
        paused = False
        while self.conn is not None:
            try:
                msg = self._try_read_msg()
                if msg is None:
                    if paused:
                        time.sleep(0.005)
                        continue
                    return
                cam = self._camera_from_msg(msg)
                payload = None
                if cam is not None:
                    from ..train.step import render_for_training
                    with torch.no_grad():
                        out = render_for_training(state, cam, sh_degree, bg,
                                                  raster_cfg)
                    img = (out["render"].clamp(0, 1) * 255).to(torch.uint8)
                    payload = memoryview(
                        img.permute(1, 2, 0).contiguous().cpu().numpy()
                        .tobytes())
                self._send(payload)
                self.keep_alive = bool(msg.get("keep_alive", False))
                if cam is None and not self.keep_alive:
                    return
                paused = not bool(msg.get("train", True))
                if not paused:
                    return
            except Exception:
                traceback.print_exc()
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None


def maybe_viewer(args) -> Optional[NetworkGUI]:
    """The training viewer's listener, unless ``--disable_viewer``; a port
    that cannot be bound is reported and training goes on without it."""
    if getattr(args, "disable_viewer", False):
        return None
    try:
        return NetworkGUI(args.ip, args.port,
                          getattr(args, "model_path", "") or "")
    except OSError as e:
        print(f"viewer listener unavailable ({e}); continuing without")
        return None
