"""The plain reference renders what the port renders (``frame_chain`` on
the CPU) at a tiny size of the configuration, its bfloat16 control does
not, and the copied ray count and the work counts match hand counts."""

import json

import numpy as np
import torch

from portbench import check, scenes
from portbench.reference import render as ref
from portbench.tests.helpers import REPO
from portbench.work import counts
from portbench.work.rays import count_rays

torch.set_num_threads(2)


def _config(name, width, height):
    conf = json.loads((REPO / f"portbench/configs/{name}.json").read_text())
    conf["render"].update(width=width, height=height)
    return scenes.scene_data(conf)


def _port_image(data, epoch, frames):
    """The port's display values and mean radiance, each (pixels, 3)."""
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer

    w, h = data.render["width"], data.render["height"]
    r = Renderer(scenes.port_scene(data), RenderConfig(**data.render),
                 lights=scenes.port_lights(data, "cpu"),
                 camera=scenes.port_camera(data, w, h), device="cpu")
    r.state = r.state._replace(frame_index=torch.tensor(epoch,
                                                        dtype=torch.int32))
    r.render_frames(frames)
    return r.image().reshape(-1, 3), r.hdr_image().reshape(-1, 3)


def _ref_image(data, epoch, frames, pixels, sd=torch.float32):
    """The reference's display values and mean radiance of `pixels`."""
    sc = ref.prepare(data, "cpu")
    pos, yaw, pitch = scenes.camera_yaw_pitch(data.camera)
    w, h = data.render["width"], data.render["height"]
    cam = ref.camera_basis(pos, yaw, pitch, data.camera["fov_degrees"], w / h)
    acc = ref.render_sums(sc, data.render, cam, pixels, epoch, frames, sd=sd)
    count = frames * data.render["spp"]
    return ref.resolve(acc, count).numpy(), (acc / count).numpy()


def _numbers(got, want):
    return check.numbers(got[0][None], want[0][None], 1 / 64, got[1][None],
                         want[1][None])


def test_reference_matches_the_port_on_the_cpu():
    data = _config("default", 40, 24)
    got = _port_image(data, 2_000_000_007, 4)
    want = _ref_image(data, 2_000_000_007, 4, np.arange(40 * 24))
    nums = _numbers(got, want)
    # the port's plain path and the reference agree bit for bit here
    assert nums == {"image_mean_abs": 0.0, "pixels_off_share": 0.0,
                    "radiance_rel_gap": 0.0}


def test_the_bfloat16_control_is_not_correct():
    data = _config("default", 48, 27)
    pixels = check.sample_pixels(5, 48, 27, 256, 4)
    want = _ref_image(data, 1000, 64, pixels)
    ctl = _ref_image(data, 1000, 64, pixels, sd=torch.bfloat16)
    nums = _numbers(ctl, want)
    limits = json.loads((REPO / "portbench/checks/default-1080p-offline.json")
                        .read_text())["limits"]
    assert not check.judge(nums, limits)[0], nums


def test_a_gap_in_bright_pixels_shows_in_the_radiance():
    # 20 of 2048 pixels are sun glints of radiance 30, and the program
    # loses a tenth of them: the tone map all but hides it from the display
    # values, the radiance gap shows it at its size
    want_rad = np.full((1, 2048, 3), 0.3)
    want_rad[0, :20] = 30.0
    got_rad = want_rad.copy()
    got_rad[0, :20] = 27.0
    shown = [ref.resolve(torch.as_tensor(r), 1).numpy()
             for r in (got_rad, want_rad)]
    nums = check.numbers(shown[0], shown[1], 1 / 64, got_rad, want_rad)
    limits = json.loads((REPO / "portbench/checks/default-1080p-offline.json")
                        .read_text())["limits"]
    assert nums["image_mean_abs"] < limits["image_mean_abs"]
    assert nums["pixels_off_share"] < limits["pixels_off_share"]
    assert nums["radiance_rel_gap"] > 10 * limits["radiance_rel_gap"]
    assert not check.judge(nums, limits)[0]


def test_count_rays_by_hand():
    # 10 primaries; 6 alive at bounce 1 and 3 at bounce 2 each traced two
    # shadow rays at the bounce before
    assert count_rays([10, 6, 3], 2) == 10 + 6 + 3 + (6 + 3) * 2
    assert count_rays([10, 6, 3], 0) == 19
    assert count_rays([7], 3) == 7


def _two_primitives():
    tri = {"positions": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
           "indices": [[0, 1, 2]], "material": 0}
    conf = {"render": {"width": 2, "height": 2, "spp": 1, "max_depth": 2},
            "camera": {"position": [0, 0, 5], "target": [0, 0, 0],
                       "fov_degrees": 60},
            "lights": [{"kind": "directional", "direction": [0, -1, 0],
                        "color": [1, 1, 1], "intensity": 1}],
            "materials": [{"base_color": [0.5, 0.5, 0.5]}],
            "meshes": [tri],
            "instances": [{"mesh": 0, "world_from_object": np.eye(4).tolist()}],
            "spheres": [{"center": [0, 0, -2], "radius": 1, "material": 0}]}
    return scenes.scene_data(conf)


def test_work_counts_by_hand():
    data = _two_primitives()
    # 4 primaries, 2 alive at bounce 1: 6 closest-hit rays and 2 shadow
    # rays, each against one triangle (46) and one sphere (20); 2 surface
    # hits with one light; 4 camera rays; 4 pixels accumulated
    work = counts.frame_work(data, data.render, [4, 2], 1)
    assert work["flops"] == 8 * (46 + 20) + 2 * (88 + 118) + 4 * 29 + 4 * 6
    # sums read and written, count and index, one triangle, one sphere,
    # one material, one light, the camera
    assert work["bytes"] == 4 * 24 + 16 + 40 + 20 + 44 + 44 + 56
    peak = {"fp32_flops_per_s": 1e3, "hbm_bytes_per_s": 1e3}
    assert counts.least_seconds(work, peak) == work["flops"] / 1e3


def test_work_counts_stop_at_an_accelerated_scene():
    data = _config("default", 8, 8)
    assert counts.frame_work(data, data.render, [64, 10], 1) is not None
    many = data._replace(
        sphere_center=np.zeros((counts.BRUTE_FORCE_MAX, 3), np.float32),
        sphere_radius=np.ones(counts.BRUTE_FORCE_MAX, np.float32),
        sphere_material=np.zeros(counts.BRUTE_FORCE_MAX, np.int64))
    assert counts.frame_work(many, data.render, [64, 10], 1) is None
