"""Interactive map visualizer.

Port of ``shine_mapping_tpu/visualizer.py`` (numpy and PIL, no torch: the
same class, the same PNG bytes).  Parity target: reference
``MapVisualizer`` (utils/visualizer.py:28-201): a
non-blocking window showing the current scan (golden), sensor pose frame
and the latest mesh, with key controls —

* [SPACE]  pause / resume the mapping loop
* [N]      single-step one frame while paused
* [Q]/[ESC] quit
* [V]      toggle ego <-> global view (camera pose saved/restored)
* [F]      toggle the current-scan rendering
* [M]      toggle the mesh map rendering
* [B]/[W]  black / white background

The control state machine is plain Python (``handle_key``/``wait_if_paused``)
so it is unit-testable headless; Open3D is only needed for the interactive
window.  Without Open3D the class degrades to a
no-op with the same API; with a ``snapshot_dir`` (the drivers'
``run_path/vis`` under ``o3d_vis_on``) it writes a PNG per update instead.

Headless rendering: :meth:`render_offscreen` draws the same scene (scan
points golden, pose axes, Lambert-shaded mesh) to a PNG with a pure
numpy+PIL software rasterizer (painter's algorithm) — no display, no
Open3D — honoring the same control state (render_scan / render_map /
background / ego-vs-global camera).  This is the draw path that runs
without a display; the o3d window branch shares its scene state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:  # pragma: no cover - optional dependency
    import open3d as o3d

    _HAS_O3D = True
except ImportError:  # pragma: no cover
    _HAS_O3D = False


SCAN_COLOR = np.array([1.0, 0.843, 0.0])  # golden, like the reference

RANDOM_COLOR_TABLE = np.array(
    [
        [0.12, 0.47, 0.71],
        [1.00, 0.50, 0.05],
        [0.17, 0.63, 0.17],
        [0.84, 0.15, 0.16],
        [0.58, 0.40, 0.74],
        [0.55, 0.34, 0.29],
    ]
)

KEY_SPACE = " "
KEY_STEP = "N"
KEY_QUIT = "Q"
KEY_ESC = "\x1b"
KEY_VIEW = "V"
KEY_FRAME = "F"
KEY_MAP = "M"
KEY_BLACK = "B"
KEY_WHITE = "W"


class MapVisualizer:
    """Non-blocking visualizer; headless no-op without open3d."""

    def __init__(self, frame_axis_len: float = 0.8,
                 snapshot_dir: Optional[str] = None) -> None:
        # control state (headless-testable)
        self.playing = True          # [SPACE]
        self.step_once = False       # [N] while paused
        self.quit_requested = False  # [Q]/[ESC]
        self.global_view = False     # [V]
        self.render_scan = True      # [F]
        self.render_map = True       # [M]
        self.background = "white"    # [B]/[W]
        self.frame_axis_len = frame_axis_len
        # offscreen-rasterizer work caps (the fill loops are host Python;
        # city-scale meshes would otherwise cost minutes per snapshot)
        self.max_draw_triangles = 60000
        self.max_draw_points = 20000
        # headless snapshot mode: without Open3D, each update() renders
        # an offscreen PNG frame here instead of drawing a window
        self.snapshot_dir = snapshot_dir
        self._snap_count = 0
        self._last_mesh = None

        self._vis = None
        self._saved_camera = None
        self._reset_bounding_box = True
        if not _HAS_O3D:
            if snapshot_dir:
                import os as _os

                _os.makedirs(snapshot_dir, exist_ok=True)
                print(f"open3d not available: visualizer renders offscreen "
                      f"PNG frames to {snapshot_dir}")
            else:
                print("open3d not available: visualizer runs headless (no-op)")
            return
        self._init_window()  # pragma: no cover — requires a display

    # ---------------------------------------------------------------- state
    def handle_key(self, key: str) -> None:
        """Apply one key press to the control state (display-independent)."""
        key = key.upper() if key != KEY_ESC else key
        if key == KEY_SPACE.upper() or key == KEY_SPACE:
            self.playing = not self.playing
        elif key == KEY_STEP:
            if not self.playing:
                self.step_once = True
        elif key in (KEY_QUIT, KEY_ESC):
            self.quit_requested = True
        elif key == KEY_VIEW:
            self.global_view = not self.global_view
        elif key == KEY_FRAME:
            self.render_scan = not self.render_scan
        elif key == KEY_MAP:
            self.render_map = not self.render_map
        elif key == KEY_BLACK:
            self.background = "black"
        elif key == KEY_WHITE:
            self.background = "white"

    def should_advance(self) -> bool:
        """One mapping step allowed? True when playing, or when a [N] step
        was requested while paused (consumes the step)."""
        if self.quit_requested:
            return False
        if self.playing:
            return True
        if self.step_once:
            self.step_once = False
            return True
        return False

    # ---------------------------------------------------------------- o3d
    def _init_window(self):  # pragma: no cover — requires a display
        self._vis = o3d.visualization.VisualizerWithKeyCallback()
        self._vis.create_window(window_name="shine_mapping_tpu_torch", width=1920, height=1080)
        for key in (KEY_SPACE, KEY_STEP, KEY_QUIT, KEY_ESC, KEY_VIEW,
                    KEY_FRAME, KEY_MAP, KEY_BLACK, KEY_WHITE):
            self._vis.register_key_callback(
                ord(key), lambda _v, k=key: self._on_key(k)
            )
        self._scan = o3d.geometry.PointCloud()
        self._mesh = o3d.geometry.TriangleMesh()
        self._frame = o3d.geometry.TriangleMesh.create_coordinate_frame(
            size=self.frame_axis_len
        )
        self._vis.add_geometry(self._scan)
        self._vis.add_geometry(self._mesh)
        self._vis.add_geometry(self._frame)
        opt = self._vis.get_render_option()
        opt.background_color = [1.0, 1.0, 1.0]
        opt.point_size = 2
        opt.light_on = True
        self._view_control = self._vis.get_view_control()
        self._saved_camera = (
            self._view_control.convert_to_pinhole_camera_parameters()
        )
        print(
            "MapVisualizer: [SPACE] pause/start, [N] step, [Q]/[ESC] quit, "
            "[V] ego/global view, [F] scan, [M] map, [B]/[W] background"
        )

    def _on_key(self, key: str):  # pragma: no cover
        was_global = self.global_view
        self.handle_key(key)
        if self.quit_requested:
            print("Destroying visualizer")
            self._vis.destroy_window()
            import os as _os

            _os._exit(0)
        opt = self._vis.get_render_option()
        opt.background_color = (
            [0.0, 0.0, 0.0] if self.background == "black" else [1.0, 1.0, 1.0]
        )
        if self.global_view != was_global:
            # swap camera: save the current pose, restore the other view's
            self._vis.update_renderer()
            self._vis.reset_view_point(True)
            current = self._view_control.convert_to_pinhole_camera_parameters()
            if self._saved_camera is not None and not self.global_view:
                self._view_control.convert_from_pinhole_camera_parameters(
                    self._saved_camera
                )
            self._saved_camera = current
        return False

    # ---------------------------------------------------------------- API
    def update(self, scan_pc=None, pose: Optional[np.ndarray] = None, mesh=None) -> None:
        if self._vis is None:
            if self.snapshot_dir is not None:
                import os as _os

                # keep showing the latest mesh between mesh updates, like
                # the window does
                self._last_mesh = mesh if mesh is not None else self._last_mesh
                self.render_offscreen(
                    _os.path.join(self.snapshot_dir,
                                  f"vis_{self._snap_count:04d}.png"),
                    scan_pc=scan_pc, pose=pose, mesh=self._last_mesh,
                )
                self._snap_count += 1
            return
        # pragma: no cover — requires a display
        if scan_pc is not None:
            if self.render_scan:
                self._scan.points = o3d.utility.Vector3dVector(scan_pc.points)
                self._scan.paint_uniform_color(SCAN_COLOR)
            else:
                self._scan.points = o3d.utility.Vector3dVector()
        if pose is not None:
            self._vis.remove_geometry(self._frame, False)
            self._frame = o3d.geometry.TriangleMesh.create_coordinate_frame(
                size=self.frame_axis_len
            )
            self._frame.transform(pose)
            self._vis.add_geometry(self._frame, self._reset_bounding_box)
            if not self.global_view and self._saved_camera is None:
                # camera-follow in ego view: keep the sensor centred
                self._vis.reset_view_point(False)
        if mesh is not None and self.render_map:
            self._mesh.vertices = o3d.utility.Vector3dVector(mesh.vertices)
            self._mesh.triangles = o3d.utility.Vector3iVector(mesh.triangles)
            if mesh.vertex_colors is not None:
                self._mesh.vertex_colors = o3d.utility.Vector3dVector(
                    mesh.vertex_colors
                )
            self._mesh.compute_vertex_normals()
        elif not self.render_map:
            self._mesh.vertices = o3d.utility.Vector3dVector()
            self._mesh.triangles = o3d.utility.Vector3iVector()
        self._vis.update_geometry(self._scan)
        self._vis.update_geometry(self._mesh)
        if self._reset_bounding_box:
            self._vis.reset_view_point(True)
            self._reset_bounding_box = False
        self._vis.poll_events()
        self._vis.update_renderer()
        self.wait_if_paused()

    def wait_if_paused(self) -> None:
        """Block (polling events) while paused, until resume or [N]."""
        if self._vis is None:
            return
        while not self.should_advance():  # pragma: no cover
            self._vis.poll_events()
            self._vis.update_renderer()

    def update_mesh(self, mesh) -> None:
        self.update(mesh=mesh)

    # ------------------------------------------------------- offscreen draw
    def render_offscreen(self, path: str, scan_pc=None,
                         pose: Optional[np.ndarray] = None, mesh=None,
                         width: int = 960, height: int = 540) -> np.ndarray:
        """Render the scene to a PNG headlessly (no Open3D, no display).

        Draws what the reference's window shows (utils/visualizer.py:
        165-192): the latest mesh (Lambert-shaded triangles,
        painter's-algorithm depth order), the current scan in golden, and
        the sensor pose frame (RGB = XYZ axes) — honoring the control
        state: ``render_scan``/``render_map`` toggles, ``background``
        black/white, and ``global_view`` (overhead camera) vs ego view
        (camera behind and above the sensor).  Returns the (H, W, 3)
        uint8 image and writes ``path`` when non-empty.
        """
        from PIL import Image, ImageDraw

        bg = 0 if self.background == "black" else 255
        img = Image.new("RGB", (width, height), (bg, bg, bg))
        draw = ImageDraw.Draw(img)

        pose = np.eye(4) if pose is None else np.asarray(pose, np.float64)
        sensor = pose[:3, 3]
        # camera distances scale with frame_axis_len so the same code
        # frames metric worlds (axis 0.8 m) and unit-cube worlds alike
        u = max(self.frame_axis_len, 1e-6)
        if self.global_view:
            # overhead: look straight down at the sensor from high up
            eye = sensor + np.array([0.0, 1e-3, 75.0]) * u
            up = np.array([0.0, 1.0, 0.0])
        else:
            # ego: behind and above the sensor, along its -x heading
            heading = pose[:3, 0]
            eye = sensor - 18.0 * u * heading + np.array([0.0, 0.0, 9.0]) * u
            up = np.array([0.0, 0.0, 1.0])
        fwd = sensor - eye
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right) + 1e-12
        cup = np.cross(right, fwd)
        R = np.stack([right, cup, fwd])  # world -> camera rows
        f = 0.9 * height  # focal (pixels)

        def project(p):
            """(N,3) world -> (N,2) pixel + (N,) depth (camera z)."""
            c = (p - eye) @ R.T
            z = np.maximum(c[:, 2], 1e-6)
            x = width * 0.5 + f * c[:, 0] / z
            y = height * 0.5 - f * c[:, 1] / z
            return np.stack([x, y], 1), c[:, 2]

        if mesh is not None and self.render_map and len(mesh.triangles):
            v = np.asarray(mesh.vertices, np.float64)
            t = np.asarray(mesh.triangles, np.int64)
            px, z = project(v)
            tz = z[t].mean(axis=1)
            vis = (z[t] > 0.05).all(axis=1)
            # triangle normals -> Lambert shade from a fixed light
            e1 = v[t[:, 1]] - v[t[:, 0]]
            e2 = v[t[:, 2]] - v[t[:, 0]]
            n = np.cross(e1, e2)
            n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
            light = np.array([0.3, 0.2, 0.93])
            lam = np.abs(n @ light)
            if mesh.vertex_colors is not None and len(mesh.vertex_colors):
                base = np.asarray(mesh.vertex_colors)[t].mean(axis=1)
            else:
                base = np.full((t.shape[0], 3), 0.62)
            shade = np.clip(base * (0.35 + 0.65 * lam[:, None]), 0, 1)
            xy = px[t]  # (T, 3, 2)
            onscreen = (
                (xy[..., 0].max(axis=1) >= 0) & (xy[..., 0].min(axis=1) < width)
                & (xy[..., 1].max(axis=1) >= 0) & (xy[..., 1].min(axis=1) < height)
            )
            drawable = np.flatnonzero(vis & onscreen)
            # the fill loop is host Python — cap it so a city-scale mesh
            # (millions of triangles) costs bounded time per snapshot;
            # keep the NEAREST triangles (the visually dominant ones)
            if len(drawable) > self.max_draw_triangles:
                near = np.argsort(tz[drawable])[: self.max_draw_triangles]
                drawable = drawable[near]
            order = drawable[np.argsort(-tz[drawable])]  # far -> near
            for i in order:
                c = tuple((shade[i] * 255).astype(np.uint8))
                draw.polygon([tuple(q) for q in xy[i]], fill=c)

        if scan_pc is not None and self.render_scan:
            pts = np.asarray(
                getattr(scan_pc, "points", scan_pc), np.float64)
            if len(pts):
                px, z = project(pts)
                keep = np.flatnonzero(
                    (z > 0.05) & (px[:, 0] >= 0) & (px[:, 0] < width)
                    & (px[:, 1] >= 0) & (px[:, 1] < height)
                )
                if len(keep) > self.max_draw_points:
                    # even stride keeps the scan's spatial coverage
                    keep = keep[:: -(-len(keep) // self.max_draw_points)]
                col = tuple((SCAN_COLOR * 255).astype(np.uint8))
                for x, y in px[keep][np.argsort(-z[keep])]:
                    draw.ellipse([x - 1, y - 1, x + 1, y + 1], fill=col)

        # pose frame: RGB = XYZ axes
        org = pose[:3, 3][None]
        po, _ = project(org)
        for ax, c in enumerate([(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
            tip, tz = project(org + self.frame_axis_len * pose[:3, ax][None])
            if tz[0] > 0.05:
                draw.line([tuple(po[0]), tuple(tip[0])], fill=c, width=3)

        arr = np.asarray(img)
        if path:
            img.save(path)
        return arr

    def stop(self) -> None:
        """End-of-run hold: keep the window open until resume/quit
        (reference ``MapVisualizer.stop``, utils/visualizer.py:85-91)."""
        if self._vis is None:
            return
        self.playing = False  # pragma: no cover
        self.wait_if_paused()
        self._vis.destroy_window()
