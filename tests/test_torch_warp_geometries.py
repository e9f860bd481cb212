"""u8 warp_affine on the geometries that stress the gather: a
shear-translate, the scale-1/8 rotation the TPU kernel refuses
(``WindowTooLarge``), an output larger than the source, 1×1 and 2×3
planes, ``ow % 16 != 0`` and ``inverse_map``, linear and nearest under both
borders, at 0 LSB against ref/ and the JAX op."""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.ref import ops as ref
from imageenhancement_mp_tpu.ops import warp as jw
from imageenhancement_mp_tpu_torch.ops import warp as tw
from torch_warp_cases import check, img, per_plane


GEOMETRIES = {  # name -> (source shape, M, dsize)
    "shear_translate": ((1, 30, 50), np.array([[1.0, 0.3, -10.0], [0.1, 0.9, 5.5]]), (30, 50)),
    # scale 1/8: the TPU kernel's window budget refuses it (WindowTooLarge)
    "rot45_scale_1_8": ((1, 600, 700),
                        ref.get_rotation_matrix_2d((350.0, 300.0), 45.0, 0.125), (64, 72)),
    "larger_output": ((2, 20, 30), ref.get_rotation_matrix_2d((15.0, 10.0), 10.0, 2.5),
                      (50, 70)),
    "plane_1x1": ((2, 1, 1), ref.get_rotation_matrix_2d((0.0, 0.0), 20.0, 1.0), (3, 4)),
    "plane_2x3": ((2, 2, 3), ref.get_rotation_matrix_2d((1.0, 0.5), -35.0, 0.7), (4, 5)),
    "ow_mod_16": ((1, 20, 40), ref.get_rotation_matrix_2d((20.0, 10.0), 7.0, 1.0), (19, 37)),
    "inverse_map": ((1, 20, 40), np.array([[0.9, -0.1, 3.0], [0.2, 1.05, -2.0]]), (22, 33)),
}


@pytest.mark.parametrize("border,bv", [("constant", 9.0), ("replicate", 0.0)],
                         ids=["const9", "replicate"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_warp_affine_geometries_u8(geometry, interp, border, bv):
    shape, M, dsize = GEOMETRIES[geometry]
    inv = geometry == "inverse_map"
    x = img(shape, np.uint8, 21)
    got = tw.warp_affine_planes(torch.from_numpy(x), M, dsize, interp, border, bv, inv)
    check(got, per_plane(lambda p: ref.warp_affine(p, M, dsize, interp, border, bv, inv), x),
           jw.warp_affine_planes(x, M, dsize, interp, border, bv, inv))
