"""tpt_torch.native_bridge: the four tests of tests/test_native.py on the
port's own copy of the C++ source, and the std140 bytes of
tpt_torch.scene.pack_std140 against tpt.scene.pack_std140."""

import os
import struct
import zlib

import numpy as np
import pytest

from tpt import native_bridge as jnative
from tpt.rng import np_pcg_hash
from tpt.scene import cornell_scene as jcornell_scene, demo_scene as jdemo_scene
from tpt.scene import pack_std140 as jpack_std140
from tpt_torch import native_bridge
from tpt_torch.scene import (STD140_TOTAL_FLOATS, cornell_scene, demo_scene, pack_std140,
                             unpack_std140)


@pytest.fixture(scope="module")
def native():
    if not native_bridge.native_available():
        pytest.skip(f"native toolchain unavailable: {native_bridge.build_error()}")
    return native_bridge


def test_port_keeps_its_own_source():
    src = native_bridge.SRC
    assert src.parent.parent == native_bridge.PACKAGE_DIR
    with open(os.path.join(os.path.dirname(jnative.__file__), "native", "tptnative.cpp"),
              "rb") as f:
        assert src.read_bytes() == f.read()   # a byte-for-byte copy


def test_std140_native_matches_python(native):
    scene = demo_scene().build()
    packed = native.pack_std140_native(scene)
    np.testing.assert_array_equal(packed, pack_std140(scene))
    spheres, smats, cmin, cmax, cmats = native.unpack_std140_native(packed)
    np.testing.assert_array_equal(spheres, scene.sphere_pos_radius.numpy())
    np.testing.assert_array_equal(smats, scene.sphere_material.numpy())
    np.testing.assert_array_equal(cmin, scene.cuboid_min.numpy())
    np.testing.assert_array_equal(cmax, scene.cuboid_max.numpy())
    np.testing.assert_array_equal(cmats, scene.cuboid_material.numpy())


def test_pcg_native_bit_parity(native):
    for seed in [1, 12345, 0xDEADBEEF]:
        got = native.pcg_floats_native(seed, 64)
        s, expected = seed, []
        for _ in range(64):
            word, s = np_pcg_hash(s)
            expected.append(np.float32(np.float32(word) / np.float32(2**32)))
        np.testing.assert_array_equal(got, np.array(expected, np.float32))
        np.testing.assert_array_equal(native_bridge.pcg_floats(seed, 64), got)


def _idat(data: bytes) -> bytes:
    ofs = data.index(b"IDAT")
    n = struct.unpack(">I", data[ofs - 4:ofs])[0]
    return zlib.decompress(data[ofs + 4:ofs + 4 + n])


def test_png_native_roundtrip(native, tmp_path):
    img = np.random.default_rng(7).integers(0, 256, size=(12, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    native.write_png_native(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (9, 12)
    rows = np.frombuffer(_idat(data), np.uint8).reshape(12, 1 + 9 * 3)
    assert (rows[:, 0] == 0).all()  # filter byte: none
    np.testing.assert_array_equal(rows[:, 1:].reshape(12, 9, 3), img[::-1])   # GL flip


def test_png_native_matches_python_writer(native, tmp_path):
    from tpt_torch.utils.image import write_png
    img = np.linspace(0, 1, 8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    p1, p2 = str(tmp_path / "native.png"), str(tmp_path / "python.png")
    native.write_png_native(p1, img)
    write_png(p2, img)
    assert _idat(open(p1, "rb").read()) == _idat(open(p2, "rb").read())


@pytest.mark.parametrize("name", ["demo", "cornell"])
def test_pack_std140_bytes_match_tpt(name):
    ours = {"demo": demo_scene, "cornell": cornell_scene}[name]().build()
    theirs = {"demo": jdemo_scene, "cornell": jcornell_scene}[name]().build()
    buf = pack_std140(ours)
    assert buf.dtype == np.float32 and buf.size == STD140_TOTAL_FLOATS
    assert buf.tobytes() == jpack_std140(theirs).tobytes()
    back = unpack_std140(buf, *ours.counts)
    assert back.counts == ours.counts
    assert pack_std140(back).tobytes() == buf.tobytes()
    with pytest.raises(ValueError):
        unpack_std140(buf[:-1], *ours.counts)
