"""HpmScene::Update parity (src/HpmScene.cpp:56-76 + DirLight.cpp:5-14)."""
import dataclasses

import numpy as np

from nrc_hpm.config import SceneConfig
from nrc_hpm.lights import (DirLight, dir_from_angles, lights_from_scene,
                                update_scene)


def test_update_scene3_advances_azimuth_and_preserves_fields():
    scene = dataclasses.replace(SceneConfig.preset(3), dynamic=True)
    lights = lights_from_scene(scene)
    lights = dataclasses.replace(
        lights, dir_light=DirLight.create(
            zenith=-1.2, azimuth=0.3, color=(0.9, 0.8, 0.7), strength=16.0))
    out = update_scene(lights, scene, delta_time=0.25)
    dl = out.dir_light
    assert np.isclose(float(dl.azimuth), 0.3 + 0.125)
    assert np.isclose(float(dl.zenith), -1.2)
    assert np.allclose(np.asarray(dl.color), [0.9, 0.8, 0.7])
    assert float(dl.strength) == 16.0
    want = dir_from_angles(-1.2, 0.3 + 0.125)
    assert np.allclose(np.asarray(dl.direction), want, atol=1e-6)


def test_update_scene3_wraps_at_reference_two_pi():
    scene = dataclasses.replace(SceneConfig.preset(3), dynamic=True)
    lights = lights_from_scene(scene)
    lights = dataclasses.replace(
        lights, dir_light=DirLight.create(zenith=-1.57, azimuth=6.2,
                                          strength=16.0))
    out = update_scene(lights, scene, delta_time=1.0)
    # the reference wraps with fmod(.., 2 * 3.141), not 2*pi
    assert np.isclose(float(out.dir_light.azimuth), (6.2 + 0.5) % 6.282)


def test_update_static_and_scene4_are_noops():
    s_static = SceneConfig.preset(3)
    l1 = lights_from_scene(s_static)
    assert update_scene(l1, s_static, 1.0) is l1

    s4 = dataclasses.replace(SceneConfig.preset(4), dynamic=True)
    l4 = lights_from_scene(s4)
    # scene 4's dynamic case is an explicit no-op in the reference
    assert update_scene(l4, s4, 1.0) is l4
