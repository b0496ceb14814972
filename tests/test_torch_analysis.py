"""The run configuration's tail in the port: ``ShapeCell``/``SHAPES``
field for field as the reference's, ``HW`` holding the H100 SXM's
data-sheet values where the reference keeps a TPU's, and
``launch.analysis.model_flops`` equal to the reference's for every
architecture and shape cell (the MLA branch included)."""
from __future__ import annotations

import dataclasses

import pytest

from repro import config as jconfig
from repro.configs import get_config as jget_config
from repro.launch.analysis import model_flops as jmodel_flops
from repro_torch import config
from repro_torch.configs import all_arch_names, get_config
from repro_torch.launch.analysis import model_flops


@pytest.mark.parametrize("cell", sorted(jconfig.SHAPES))
@pytest.mark.parametrize("arch", all_arch_names())
def test_model_flops_matches_reference(arch, cell):
    got = model_flops(get_config(arch), config.SHAPES[cell])
    want = jmodel_flops(jget_config(arch), jconfig.SHAPES[cell])
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0


@pytest.mark.parametrize("cell", sorted(jconfig.SHAPES))
def test_shape_cells_match_reference(cell):
    assert dataclasses.asdict(config.SHAPES[cell]) == \
        dataclasses.asdict(jconfig.SHAPES[cell])
    assert [f.name for f in dataclasses.fields(config.ShapeCell)] == \
        [f.name for f in dataclasses.fields(jconfig.ShapeCell)]
    assert set(config.SHAPES) == set(jconfig.SHAPES)
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.SHAPES[cell].seq_len = 1


def test_hw_is_the_h100_sxm():
    hw = config.HW
    assert hw == config.HWSpec()
    assert hw.name == "h100_sxm"
    assert hw.peak_flops_bf16 == 989e12          # dense bf16
    assert hw.hbm_bw == 3.35e12
    assert hw.hbm_bytes == 80e9
    assert hw.ici_bw_per_link * 18 == pytest.approx(900e9, rel=1e-15)
    assert hw.smem_bytes == 228 * 1024
    # the reference's fields, vmem_bytes renamed to smem_bytes
    names = [f.name for f in dataclasses.fields(config.HWSpec)]
    ref = [f.name for f in dataclasses.fields(jconfig.HWSpec)]
    assert names == [n.replace("vmem", "smem") for n in ref]
    # no TPU number carried over
    for f in ("peak_flops_bf16", "hbm_bw", "hbm_bytes"):
        assert getattr(hw, f) != getattr(jconfig.HW, f)


@pytest.mark.parametrize("name", sorted(config.ACCEL_PROFILES))
def test_accel_profile_keeps_the_reference_contract(name, monkeypatch):
    """``apply_accel_profile`` sets its variables with ``setdefault`` (a
    value already in ``os.environ`` wins), returns the profile, and names
    the choices when it refuses a name; ``monkeypatch`` restores the
    environment."""
    import os
    prof = config.ACCEL_PROFILES[name]
    assert set(prof) == {"env", "device"} and prof["env"]
    assert prof["device"] in ("cpu", "cuda")
    first, *rest = sorted(prof["env"])
    monkeypatch.setenv(first, "set-by-user")
    for k in rest:
        monkeypatch.delenv(k, raising=False)
    assert config.apply_accel_profile(name) is prof
    assert os.environ[first] == "set-by-user"
    for k in rest:
        assert os.environ[k] == prof["env"][k]
    # the reference's names where the port has the same accelerator
    assert name in jconfig.ACCEL_PROFILES


def test_accel_profile_refuses_an_unknown_name():
    with pytest.raises(ValueError) as e:
        config.apply_accel_profile("tpu")
    for name in config.ACCEL_PROFILES:
        assert repr(name) in str(e.value)
    assert "'tpu'" in str(e.value)
    with pytest.raises(ValueError):
        jconfig.apply_accel_profile("nope")
