"""Port parity for the host layer: ACE parsing, two-body prep and the deck.

The port copies the reference's numpy host code (ndpp_tpu imports jax at
package level, so the port cannot import it); these tests pin the copies to
the reference bit for bit on ACE files the reference writes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndpp_tpu import config as j_config
from ndpp_tpu import groups as j_groups
from ndpp_tpu.host.ace import synth
from ndpp_tpu.host.ace.parse import read_ace as j_read_ace
from ndpp_tpu.host.ace.write import write_ace
from ndpp_tpu.host.prep import prepare_twobody as j_prepare
from ndpp_tpu_torch import config as t_config
from ndpp_tpu_torch import groups as t_groups
from ndpp_tpu_torch.host.ace.parse import read_ace as t_read_ace
from ndpp_tpu_torch.host.ace import synth as t_synth
from ndpp_tpu_torch.host.prep import prepare_twobody as t_prepare
from ndpp_tpu_torch.interop import config_from_dict, group_structure

torch.set_num_threads(1)  # one thread per process: pytest-xdist runs several beside each other


@pytest.mark.parametrize("fixture,n_energy", [("h1", 40), ("fe56", 60), ("o16", 40)])
def test_read_ace_and_prepare_twobody_bit_equal(fixture, n_energy, tmp_path):
    path = write_ace(synth.ALL_FIXTURES[fixture](n_energy), tmp_path / f"{fixture}.ace")
    ref = j_read_ace(path)
    out = t_read_ace(path)
    assert (out.name, out.zaid, out.awr, out.kT) == (ref.name, ref.zaid, ref.awr, ref.kT)
    for field in ("energy", "sigma_t", "sigma_a", "sigma_el"):
        np.testing.assert_array_equal(getattr(out, field), getattr(ref, field), err_msg=field)
    r_rxns = ref.scattering_reactions(include_fission=False)
    o_rxns = out.scattering_reactions(include_fission=False)
    assert [r.mt for r in o_rxns] == [r.mt for r in r_rxns]
    for r_rxn, o_rxn in zip(r_rxns, o_rxns):
        np.testing.assert_array_equal(out.sigma_on_grid(o_rxn), ref.sigma_on_grid(r_rxn))
        sub = ref.energy[3:]
        rp, op = j_prepare(ref, r_rxn, sub), t_prepare(out, o_rxn, sub)
        for f in dataclasses.fields(rp):
            np.testing.assert_array_equal(getattr(op, f.name), getattr(rp, f.name), err_msg=f"MT={r_rxn.mt} {f.name}")


def test_synth_fixtures_match_reference():
    """chip_smoke builds its fixtures with the port's own synth (no jax on the
    card's machine): they must be the reference's nuclides."""
    for key in ("h1", "fe56", "o16"):
        ref, out = synth.ALL_FIXTURES[key](30), t_synth.ALL_FIXTURES[key](30)
        np.testing.assert_array_equal(out.energy, ref.energy)
        np.testing.assert_array_equal(out.sigma_el, ref.sigma_el)
        assert sorted(out.reactions) == sorted(ref.reactions)
    ref, out = synth.stress_nuclide(3), t_synth.stress_nuclide(3)
    np.testing.assert_array_equal(out.energy, ref.energy)


DECK = """
[run]
nuclides = ["1001.80c", "26056.80c"]
library = "lib/xsdir"
groups = "uniform-lethargy-47"
legendre_order = 3
temperatures = [293.6, 600.0]
freegas_for = ["none"]
[output]
path = "out/lib.txt"
format = "ascii"
[device]
precision = "f64"
e_tile = 64
quad_points = 12
"""


def test_config_from_dict_round_trips_a_deck(tmp_path):
    deck = tmp_path / "deck.toml"
    deck.write_text(DECK)
    ref = j_config.load(deck)
    assert config_from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert t_config.load(deck).to_dict() == ref.to_dict()
    assert t_config.RunConfig().to_dict() == j_config.RunConfig().to_dict()  # same defaults


def test_config_validation_matches():
    for bad in ({"run": {"legendre_order": 11}}, {"device": {"precision": "f32"}}, {"output": {"format": "x"}}):
        with pytest.raises(j_config.ConfigError):
            j_config._build(bad)
        with pytest.raises(t_config.ConfigError):
            t_config._build(bad)


def test_group_structures_match():
    for name in ("uniform-lethargy-47", "uniform-lethargy-361"):
        ref, out = j_groups.get(name), t_groups.get(name)
        np.testing.assert_array_equal(out.bounds, ref.bounds)
        assert out.checksum() == ref.checksum()
    gs = group_structure("custom", ref.bounds[::10])
    assert gs.ng == ref.bounds[::10].size - 1
