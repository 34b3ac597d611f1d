"""Camera backends of the agent (nerfsafetyvalidation_tpu/nav/camera.py),
numpy: `BlenderCamera` (the reference's external Blender process: pose JSON
in, PNG out), `NerfCamera` (the NeRF renders the observation) and
`CannedCamera` (a fixed image, for tests). Each `capture(data, iteration)`
returns an RGB uint8 image [H, W, 3]."""

import json
import os
import subprocess

import numpy as np


class CameraBackend:
    def capture(self, data: dict, iteration: int) -> np.ndarray:
        """data: the camera config, with 'pose' (4x4 nested list)."""
        raise NotImplementedError


class BlenderCamera(CameraBackend):
    """The reference's protocol (agent_helpers.py:150-184): the pose as
    JSON, `blender -b <blend> -P <script> -- pose.json img.png`, the PNG
    read back, halved with `half_res`, composited on white with
    `white_bg`."""

    def __init__(self, path, blend_file, script_path, half_res=False,
                 white_bg=True):
        self.path = path
        self.blend = blend_file
        self.blend_script = script_path
        self.half_res = half_res
        self.white_bg = white_bg

    def capture(self, data, iteration):
        import imageio
        try:
            import cv2
        except ImportError:
            cv2 = None
        os.makedirs(self.path, exist_ok=True)
        pose_path = os.path.join(self.path, f"{iteration}.json")
        img_path = os.path.join(self.path, f"{iteration}.png")
        with open(pose_path, "w+") as f:
            json.dump(data, f, indent=4)
        subprocess.run(["blender", "-b", self.blend, "-P", self.blend_script,
                        "--", pose_path, img_path], check=False)
        img = (np.array(imageio.imread(img_path)) / 255.0).astype(np.float32)
        if self.half_res and cv2 is not None:
            img = cv2.resize(img, (img.shape[1] // 2, img.shape[0] // 2))
        if self.white_bg and img.shape[-1] == 4:
            img = img[..., :3] * img[..., -1:] + (1.0 - img[..., -1:])
        return (img * 255.0).astype(np.uint8)


class NerfCamera(CameraBackend):
    """The NeRF as the camera: render_from_pose_fn(pose [4, 4] float32)
    -> rgb [H * W, 3] (numpy or a tensor), clipped to [0, 1]."""

    def __init__(self, render_from_pose_fn, res_x=800, res_y=800):
        self.render_from_pose = render_from_pose_fn
        self.res_x = res_x
        self.res_y = res_y

    def capture(self, data, iteration):
        rgb = self.render_from_pose(np.asarray(data["pose"], np.float32))
        if hasattr(rgb, "detach"):
            rgb = rgb.detach().cpu().numpy()
        img = np.asarray(rgb).reshape(self.res_y, self.res_x, -1)[..., :3]
        return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


class CannedCamera(CameraBackend):
    """A fixed image (mid grey by default); remembers the poses asked for."""

    def __init__(self, image=None, res_x=64, res_y=64):
        if image is None:
            image = np.full((res_y, res_x, 3), 128, dtype=np.uint8)
        self.image = np.asarray(image, dtype=np.uint8)
        self.poses = []

    def capture(self, data, iteration):
        self.poses.append(np.asarray(data["pose"]))
        return self.image.copy()
