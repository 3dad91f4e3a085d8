"""The native IO of ndr_tpu_torch (``io/native.py`` over the repo's
``native/ndrio.cpp``, built into ``build/ndr_tpu_torch/``) against the JAX
package's (``ndr_tpu/io/native.py`` over ``native/libndrio.so``): the files
each writes are byte-equal and read back equal; ``load_ct`` with the
in-plane resize agrees to 1e-6 (fp32). The Python writers are taken only
when asked for, and a failed build raises with the compiler's message.
"""

import numpy as np
import pytest
import torch

from ndr_tpu.grid import make_grid as j_make_grid
from ndr_tpu.io import export as jexport
from ndr_tpu.io import native as jnative
from ndr_tpu_torch.grid import make_grid
from ndr_tpu_torch.io import export, native

CASES = [((4, 3), [[0, 0], [2, 1]]), ((3, 2, 2), None), ((5, 4, 3), [[0, 0, 0], [5, 2, 1]])]


def _field(dims, seed=1):
    return np.random.default_rng(seed).uniform(size=dims)


@pytest.mark.parametrize("dims,corners", CASES)
def test_msh_byte_equal_to_jax_and_reads_back(tmp_path, dims, corners):
    grid, jgrid = make_grid(dims, corners), j_make_grid(dims, corners)
    field = _field(dims)
    ours, theirs = str(tmp_path / "port.msh"), str(tmp_path / "jax.msh")
    assert native.write_msh(ours, grid, torch.tensor(field)) == ours
    assert jnative.write_msh(theirs, jgrid, field)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = native.read_msh_field(ours, "density", grid.num_elements)
    np.testing.assert_array_equal(back.reshape(dims), field)
    np.testing.assert_array_equal(
        jnative.read_msh_field(ours, "density", grid.num_elements), back)
    # the Python writer, when asked for, is the JAX package's ASCII file
    py, jpy = str(tmp_path / "py.msh"), str(tmp_path / "jpy.msh")
    native.write_msh(py, grid, field, use_native=False)
    jexport.write_msh(jpy, jgrid, {"density": field})
    assert open(py).read() == open(jpy).read()
    np.testing.assert_array_equal(
        native.read_msh_field(py, "density", grid.num_elements).reshape(dims), field)


@pytest.mark.parametrize("dims", [(4, 3), (5, 4, 3)])
def test_vtr_byte_equal_to_jax_and_reads_back(tmp_path, dims):
    field = _field(dims, seed=2)
    ours = native.write_vtr(str(tmp_path / "port"), torch.tensor(field),
                            spacing=(0.5, 1.0, 2.0), name="density")
    theirs = str(tmp_path / "jax.vtr")
    assert jnative.write_vtr(theirs, field, spacing=(0.5, 1.0, 2.0), name="density")
    assert ours.endswith(".vtr") and open(ours, "rb").read() == open(theirs, "rb").read()
    full = field if len(dims) == 3 else field[..., None]
    np.testing.assert_array_equal(export.read_vtr(ours)["density"], full)
    py = native.write_vtr(str(tmp_path / "py"), field, name="density", use_native=False)
    np.testing.assert_array_equal(export.read_vtr(py)["density"], full)


@pytest.mark.parametrize("use_native", [True, False])
def test_load_ct_with_resize_matches_jax(tmp_path, use_native):
    rng = np.random.default_rng(3)
    h, w, n = 6, 5, 4
    for s in range(n):
        data = rng.integers(0, 65535, size=(h, w), dtype=np.uint16)
        (tmp_path / f"slice_{s:03d}.raw").write_bytes(data.astype(">u2").tobytes())
    vol = native.load_ct(str(tmp_path), (h, w), use_native=use_native)
    np.testing.assert_array_equal(vol, jnative.load_ct(str(tmp_path), (h, w)))
    for size in ((9, 7), (3, 4)):
        ours = native.load_ct(str(tmp_path), (h, w), interpolate_size=size,
                              use_native=use_native)
        theirs = jnative.load_ct(str(tmp_path), (h, w), interpolate_size=size)
        assert ours.shape == theirs.shape == size + (n,) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


def test_build_is_keyed_and_failure_raises(tmp_path, monkeypatch):
    path = native.build()
    assert path.parent.name == "ndr_tpu_torch" and path.parent.parent.name == "build"
    assert native.build() == path  # cached: no second compile
    bad = tmp_path / "ndrio.cpp"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(native, "_SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
