"""The port's host tools against tpt's: ray picking (tpt_torch.pick, a copy
of the NumPy-only tpt.pick against the port's scene objects), ``cli pick``
and ``cli sky``.

Bars: a pick names the same object with t1, t2 within 1e-4 relative
(the port's camera matrices are torch's, tpt's are JAX's; both f32); the
two ``pick`` subcommands print the same text; the two sky PNGs differ by at
most one level in any channel (the atmosphere's marches round differently
in torch and XLA: tests/test_torch_sky.py)."""

import os

import numpy as np
import pytest
import torch

from tpt import camera as jcam
from tpt import cli as jcli
from tpt import pick as jpick
from tpt import scene as jscene
from tpt_torch import CameraConfig, cli, demo_scene, pick
from tpt_torch.camera import camera_matrices

torch.set_num_threads(1)
W, H = 832, 832   # the CLI's default window
# window points (y from the top) over the demo scene from the reference
# camera, each on another object: spheres of the grid and of the glass
# rows, the walls and the floor; MISS is above the scene, where nothing is
MISS = (416, 0)
POINTS = [(416, 416), (704, 320), (768, 448), (256, 448), (320, 448), (384, 576),
          (192, 704), (448, 640), (640, 384), (64, 320), (768, 192)]


def picks(x, y, cam=CameraConfig()):
    builder, jbuilder = demo_scene(), jscene.demo_scene()
    ip, iv, pos = camera_matrices(cam, W, H)
    jip, jiv, jpos = jcam.camera_matrices(cam, W, H)
    got = pick.pick_pixel(builder, ip, iv, pos, x, y, W, H)
    want = jpick.pick_pixel(jbuilder, np.asarray(jip), np.asarray(jiv), np.asarray(jpos), x, y,
                            W, H)
    index = lambda b, o: None if o is None else b.objects.index(o)
    return (index(builder, got[0]), *got[1:]), (index(jbuilder, want[0]), *want[1:])


@pytest.mark.parametrize("point", POINTS + [MISS])
def test_pick_pixel_matches_tpt(point):
    got, want = picks(*point)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4, atol=1e-6)
    if point == MISS:
        assert got == (None, 0.0, 0.0)


def test_points_pick_objects():
    hit = [picks(*p)[0][0] for p in POINTS]
    assert None not in hit and len(set(hit)) == len(POINTS)


def test_pick_ray_matches_tpt():
    rng = np.random.default_rng(5)
    builder, jbuilder = demo_scene(), jscene.demo_scene()
    origins = rng.uniform(-15, 15, (32, 3)).astype(np.float32)
    dirs = rng.normal(size=(32, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    n_hit = 0
    for o, d in zip(origins, dirs):
        got, want = pick.pick_ray(builder, o, d), jpick.pick_ray(jbuilder, o, d)
        got_i = None if got[0] is None else builder.objects.index(got[0])
        want_i = None if want[0] is None else jbuilder.objects.index(want[0])
        assert got_i == want_i and got[1:] == want[1:]
        n_hit += got_i is not None
    assert n_hit > 8


@pytest.mark.parametrize("point", [(416, 416), (700, 300), MISS])
def test_cli_pick_prints_what_tpt_prints(point, capsys):
    flags = ["pick", "--x", str(point[0]), "--y", str(point[1])]
    assert jcli.main(flags) == 0
    want = capsys.readouterr().out
    assert cli.main(flags) == 0
    got = capsys.readouterr().out
    assert got == want
    assert ("nothing" in got) == (point == MISS)


def test_cli_sky_matches_tpt(tmp_path):
    flags = ["--atmosphere-size", "16", "--isteps", "6", "--jsteps", "3", "--time", "0.3"]
    got, want = os.path.join(tmp_path, "port.png"), os.path.join(tmp_path, "tpt.png")
    assert cli.main(["sky", "--device", "cpu", *flags, "--out", got]) == 0
    assert jcli.main(["sky", "--platform", "cpu", *flags, "--out", want]) == 0
    from PIL import Image
    with Image.open(got) as a, Image.open(want) as b:
        a, b = np.asarray(a.convert("RGB"), np.int16), np.asarray(b.convert("RGB"), np.int16)
    assert a.shape == b.shape == (16, 6 * 16, 3)
    assert np.abs(a - b).max() <= 1 and a.max() > 0


def test_cli_sky_needs_the_card_it_names():
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sky", "--device", "cuda", "--atmosphere-size", "4", "--out", os.devnull])
