import jax.numpy as jnp
import numpy as np
import pytest

from nrc_hpm.camera import Camera
from nrc_hpm.models.mesh import Material, Model, load_obj, make_cube
from nrc_hpm.models.raster import ModelRenderer


def test_cube_geometry():
    cube = make_cube(2.0)
    m = cube.meshes[0]
    assert m.positions.shape == (24, 3)
    assert m.indices.shape == (12, 3)
    assert np.abs(m.positions).max() == 1.0


def test_obj_loader(tmp_path):
    obj = tmp_path / "tri.obj"
    mtl = tmp_path / "tri.mtl"
    mtl.write_text("newmtl red\nKd 1.0 0.0 0.0\n")
    obj.write_text(
        "mtllib tri.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "usemtl red\n"
        "f 1/1/1 2/2/1 3/3/1 4/3/1\n")  # quad -> 2 triangles
    model = load_obj(str(obj))
    assert len(model.meshes) == 1
    mesh = model.meshes[0]
    assert mesh.indices.shape == (2, 3)
    assert np.allclose(mesh.material.diffuse_color, [1, 0, 0])
    assert np.allclose(mesh.normals[0], [0, 0, 1])


def test_model_renderer_hits_cube():
    r = ModelRenderer(64, 48)
    cube = make_cube(2.0)
    r.add_model(cube)
    cam = Camera.create((0.0, 0.0, 5.0), (0.0, 0.0, -1.0), aspect=64 / 48)
    img, depth = r.render(cam)
    img = np.asarray(img)
    depth = np.asarray(depth)
    assert img.shape == (48, 64, 4)
    # center pixel hits the cube front face at depth ~4
    assert img[24, 32, 3] == 1.0
    assert abs(depth[24, 32] - 4.0) < 0.05
    # corners miss -> background
    assert img[0, 0, 3] == 0.0
    assert np.allclose(img[0, 0, :3], [0.05, 0.05, 0.08], atol=1e-5)
    # hit fraction is sensible for a 2-unit cube at distance 5, fov 60
    frac = img[..., 3].mean()
    assert 0.05 < frac < 0.5


def test_model_transform_moves_cube():
    r = ModelRenderer(32, 32)
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 100.0  # move far right: out of view
    r.add_model(make_cube(2.0).transformed(t))
    cam = Camera.create((0.0, 0.0, 5.0), (0.0, 0.0, -1.0), aspect=1.0)
    img, _ = r.render(cam)
    assert np.asarray(img)[..., 3].sum() == 0.0


def test_bilinear_sampler_exact_at_centers_and_interp():
    from nrc_hpm.utils.texture import bilinear_sample
    tex = np.zeros((2, 2, 3), np.float32)
    tex[0, 0] = [1, 0, 0]
    tex[0, 1] = [0, 1, 0]
    tex[1, 0] = [0, 0, 1]
    tex[1, 1] = [1, 1, 1]
    # texel centers
    uv = np.array([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.5, 0.5]],
                  np.float32)
    out = np.asarray(bilinear_sample(jnp.asarray(tex), jnp.asarray(uv)))
    np.testing.assert_allclose(out[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[1], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(out[2], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(out[3], [0.5, 0.5, 0.5], atol=1e-6)


def test_textured_cube_renders_texture_colors():
    """Diffuse textures must be sampled per fragment (src/Material.cpp,
    src/Texture2D.cpp): a cube textured half red / half green must show
    both colors on screen, matching each fragment's uv."""
    from nrc_hpm.models.mesh import make_cube
    from nrc_hpm.models.raster import ModelRenderer

    model = make_cube(1.0)
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = [1.0, 0.0, 0.0]   # u < 0.5 red
    tex[:, 4:] = [0.0, 1.0, 0.0]   # u >= 0.5 green
    for mesh in model.meshes:
        mesh.material.diffuse_texture = tex

    r = ModelRenderer(64, 64, background=(0, 0, 0))
    r.add_model(model)
    cam = Camera.create((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), aspect=1.0)
    img, depth = r.render(cam)
    img = np.asarray(img)
    hit = img[..., 3] > 0.5
    assert hit.sum() > 200
    rgb = img[..., :3][hit]
    reds = (rgb[:, 0] > 0.1) & (rgb[:, 1] < 1e-3)
    greens = (rgb[:, 1] > 0.1) & (rgb[:, 0] < 1e-3)
    assert reds.sum() > 50 and greens.sum() > 50
    # untextured render differs
    model2 = make_cube(1.0)
    r2 = ModelRenderer(64, 64, background=(0, 0, 0))
    r2.add_model(model2)
    img2, _ = r2.render(cam)
    assert not np.allclose(img, np.asarray(img2))
