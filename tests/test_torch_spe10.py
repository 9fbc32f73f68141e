"""Port parity: SPE10 data, well masks and fields with the flagship's
full-height perforations, and the presets field by field, against the JAX
package (CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import thermalporous_torch.physics as tp
from tests._torch_parity import F64, assert_close
from thermalporous_torch import presets as tpre
from thermalporous_torch.core import Grid
from thermalporous_torch.data import spe10 as tspe
from thermalporous_torch.interop import config_from_dict
from thermalporous_torch.models import make_problem_data
from thermalporous_torch.precond import CPRConfig
from thermalporous_torch.solve.timeloop import TimeConfig
from thermalporous_tpu import presets as jpre
from thermalporous_tpu.core import Grid as JGrid
from thermalporous_tpu.data import spe10 as jspe
from thermalporous_tpu.models import make_problem_data as j_make_problem_data
from thermalporous_tpu.physics import PhysicalParams as JPhysicalParams
from thermalporous_tpu.physics import Well as JWell
from thermalporous_tpu.physics import build_well_fields as j_build_well_fields
from thermalporous_tpu.physics import per_well_masks as j_per_well_masks

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,seed,frac", [
    ((12, 22, 9), 2020, None), ((8, 14, 6), 7, None), ((10, 12, 16), 2020, 0.5),
    ((6, 9, 1), 3, 1.0),
])
def test_synthetic_spe10_bitwise(shape, seed, frac):
    kw = {} if frac is None else dict(tarbert_frac=frac)
    got = tspe.synthetic_spe10(shape=shape, seed=seed, **kw)
    ref = jspe.synthetic_spe10(shape=shape, seed=seed, **kw)
    for name in ("kx", "ky", "kz", "phi"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    lay = got.layer(2 % shape[2])
    assert np.array_equal(lay.kx, ref.layer(2 % shape[2]).kx)
    box = got.subbox(slice(1, 4), slice(0, 5), slice(0, 1))
    assert np.array_equal(box.phi, ref.subbox(slice(1, 4), slice(0, 5), slice(0, 1)).phi)


def test_spe10_constants_and_loader(tmp_path):
    assert tspe.SPE10_SHAPE == jspe.SPE10_SHAPE
    assert tspe.SPE10_SPACING_M == jspe.SPE10_SPACING_M
    assert tspe.SPE10_TARBERT_LAYERS == jspe.SPE10_TARBERT_LAYERS
    assert tspe.MD_TO_M2 == jspe.MD_TO_M2
    perm = tmp_path / "perm.dat"
    perm.write_text("1 2 3\n4 5\n")
    assert np.array_equal(tspe._read_floats(str(perm), 10), [1, 2, 3, 4, 5])
    with pytest.raises(ValueError):          # a file of the wrong size
        tspe.load_spe10(str(perm), str(perm))


def _flagship_style(shape):
    """Grid and the flagship's five full-height wells at ``shape``, in both
    packages."""
    nx, ny, nz = shape
    fields = jspe.synthetic_spe10(shape=shape, seed=2020)
    kw = dict(shape=shape, spacing=jspe.SPE10_SPACING_M, gravity=9.81,
              depth_top=3600.0 * 0.3048)
    twells = tpre._flagship_wells(nx, ny, nz)
    jwells = [JWell(cells=w.cells, control=w.control, p_bh=w.p_bh, T_inj=w.T_inj,
                    name=w.name) for w in twells]
    return fields, JGrid(**kw), Grid(**kw), jwells, twells


def test_full_height_wells_with_gravity():
    """85-cell vertical perforations on a 3D grid with gravity: the masks,
    the well fields and the packed problem data."""
    fields, jg, tg, jwells, twells = _flagship_style((7, 9, 85))
    jm = j_per_well_masks(jg, jwells)
    tm = tp.per_well_masks(tg, twells)
    assert list(tm) == list(jm) == ["INJ", "P_2_2", "P_4_2", "P_2_6", "P_4_6"]
    for name in jm:
        assert np.array_equal(tm[name], jm[name])
        assert tm[name].sum() == 85
    wf = tp.build_well_fields(tg, twells, kx=fields.kx, ky=fields.ky, dtype=F64,
                              device="cpu")
    jw = j_build_well_fields(jg, jwells, kx=fields.kx, ky=fields.ky)
    for name in ("wi", "pbh", "tinj", "has_tinj", "qrate", "qheat"):
        assert_close(getattr(wf, name), getattr(jw, name), 1e-14)
    assert float(wf.wi.sum()) > 0 and int((wf.wi > 0).sum()) == 5 * 85
    pp = JPhysicalParams()
    jd = j_make_problem_data(jg, pp, kx=fields.kx, ky=fields.ky, kz=fields.kz,
                             phi=fields.phi, wells=jwells)
    td = make_problem_data(tg, tp.PhysicalParams(), kx=fields.kx, ky=fields.ky,
                           kz=fields.kz, phi=fields.phi, wells=twells, dtype=F64,
                           device="cpu")
    assert_close(td.fields, _jax_fields(jd), 1e-13)


def _jax_fields(jd) -> np.ndarray:
    """The JAX ProblemData stacked in the port's channel order."""
    w = jd.wells
    parts = [*jd.tgeo, *jd.tcond, jd.phi, w.wi, w.pbh, w.tinj, w.has_tinj, w.qrate,
             w.qheat]
    return np.stack([np.asarray(p) for p in parts])


def _compare_case(got, ref):
    assert got.name == ref.name and got.description == ref.description
    assert got.precond == ref.precond and got.t_end == ref.t_end
    assert type(got.model).__name__ == type(ref.model).__name__
    assert got.model.nc == ref.model.nc
    assert dataclasses.asdict(got.model.grid) == dataclasses.asdict(ref.model.grid)
    assert dataclasses.asdict(got.model.pp) == dataclasses.asdict(ref.model.pp)
    if ref.model.nc == 3:
        assert got.model.s_init == ref.model.s_init
        assert dataclasses.asdict(got.model.relperm) == dataclasses.asdict(ref.model.relperm)
    assert dataclasses.asdict(got.time_cfg) == dataclasses.asdict(ref.time_cfg)
    assert dataclasses.asdict(got.newton_cfg) == dataclasses.asdict(ref.newton_cfg)
    ref_pc = None if ref.pc_cfg is None else config_from_dict(
        CPRConfig, dataclasses.asdict(ref.pc_cfg))
    assert got.pc_cfg == ref_pc
    assert list(got.well_masks) == list(ref.well_masks)
    for name, m in ref.well_masks.items():
        assert np.array_equal(got.well_masks[name], m)
    assert_close(got.data.fields, _jax_fields(ref.data), 1e-13)


@pytest.mark.parametrize("name,kw", [
    ("sp_hot_injection_2d", dict(n=8)),
    ("sp_spe10_layer_2d", dict(layer=3)),
    ("sp_geothermal_3d", dict(nx=8, ny=10, nz=6)),
    ("tp_thermal_2d", dict(n=12)),
    ("tp_spe10_3d", dict(nx=10, ny=14, nz=6)),
    ("tp_spe10_full", {}),
    ("tp_spe10_inner", {}),
])
def test_presets_match(name, kw):
    """Every field of the port's preset equals the reference's (f64 data)."""
    got = tpre.get_case(name, device="cpu", dtype=F64, **kw)
    ref = jpre.get_case(name, **kw)
    _compare_case(got, ref)
    assert got.data.fields.dtype == F64
    assert tpre.get_case(name, device="cpu", **kw).data.fields.dtype == torch.float32


def test_padded_preset_matches():
    got = tpre.get_case("tp_spe10_padded", device="cpu", dtype=F64, nz_pad=86)
    ref = jpre.get_case("tp_spe10_padded", nz_pad=86)
    _compare_case(got, ref)
    assert tuple(got.data.fields.shape) == (13, 60, 220, 86)
    with pytest.raises(ValueError):
        tpre.get_case("tp_spe10_padded", device="cpu", nz_pad=80)


def test_small_flagship_is_the_flagship_configuration():
    """``shape`` changes only the grid: the configurations are the preset's,
    and the fields are those of synthetic_spe10 at that shape."""
    got = tpre.get_case("tp_spe10_full", device="cpu", dtype=F64, shape=(8, 14, 6))
    time_cfg, newton_cfg, pc_cfg = tpre.flagship_configs()
    assert (got.time_cfg, got.newton_cfg, got.pc_cfg) == (time_cfg, newton_cfg, pc_cfg)
    fields, jg, _, jwells, _ = _flagship_style((8, 14, 6))
    jd = j_make_problem_data(jg, JPhysicalParams(), kx=fields.kx, ky=fields.ky,
                             kz=fields.kz, phi=fields.phi, wells=jwells)
    assert_close(got.data.fields, _jax_fields(jd), 1e-13)
    # the single-phase presets build (at their preset sizes) and name their
    # reference's descriptions; an unknown name is refused
    for name in ("sp_hot_injection_2d", "sp_spe10_layer_2d", "sp_geothermal_3d"):
        case = tpre.get_case(name, device="cpu")
        assert type(case.model).__name__ == "SinglePhaseModel"
        assert case.description == jpre.CASE_DESCRIPTIONS[name]
    assert {k: jpre.CASE_DESCRIPTIONS[k] for k in tpre.CASE_DESCRIPTIONS} \
        == tpre.CASE_DESCRIPTIONS
    assert set(tpre.CASE_DESCRIPTIONS) == set(tpre.PRESETS)
    with pytest.raises(KeyError):
        tpre.get_case("tp_spe10_outer", device="cpu")
    assert isinstance(got.time_cfg, TimeConfig)
