"""Port parity of the scenario zoo (``repro_torch.core.zoo``): the same
families, names, sizes, help strings and expansions as the JAX
package's ``repro.core.zoo``, and the same spec grammar and errors."""
import dataclasses

import pytest

from repro.core import zoo as jzoo
from repro.core.config import SimConfig as JConfig

from repro_torch.core import engine as tengine
from repro_torch.core import zoo as tzoo
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.workloads import PATTERN_NAMES


def flat(scenarios):
    return [(dataclasses.asdict(s.cfg), s.app, s.seed, s.refs_per_core)
            for s in scenarios]


def test_families_equal_the_reference():
    assert tzoo.family_names() == jzoo.family_names()
    assert tzoo.zoo_summary() == jzoo.zoo_summary()
    for name in tzoo.family_names():
        t, j = tzoo.get_family(name), jzoo.get_family(name)
        assert (t.name, t.help, t.meshes, t.sources, t.seeds, t.refs,
                dict(t.base)) == (j.name, j.help, j.meshes, j.sources,
                                  j.seeds, j.refs, dict(j.base))
        assert t.size == len(t.expand()) == j.size
        assert flat(t.expand()) == flat(j.expand())
        assert t.manifest() == j.manifest()
        assert flat(tengine.load_manifest(t.manifest())) == flat(t.expand())
    assert tzoo.get_family("patterns-small").size == 2 * len(PATTERN_NAMES) * 2


@pytest.mark.parametrize("spec", [
    "patterns-tiny", "patterns-small:refs=7,seeds=3+4,meshes=4x4",
    "wedge:sources=loop:matmul+random", "apps-small:meshes=4x4+6x6,refs=5",
    "hotspot-stress: refs = 9 ,"])
def test_expand_zoo_equals_the_reference(spec):
    base_t = TConfig(addr_bits=14, rob_slots=4)
    base_j = JConfig(addr_bits=14, rob_slots=4)
    got = tzoo.expand_zoo(spec, base=base_t)
    assert flat(got) == flat(jzoo.expand_zoo(spec, base=base_j))
    for sc in got:
        sc.validate()
        assert sc.cfg.addr_bits == 14 and sc.cfg.rob_slots == 4
        assert not sc.cfg.centralized_directory   # family override wins


@pytest.mark.parametrize("spec,match", [
    ("nope", "unknown zoo family"), ("wedge:refs", "key=val"),
    ("wedge:bogus=1", "key=val"), ("wedge:sources=bogus", "invalid source")])
def test_bad_specs_raise_the_reference_errors(spec, match):
    with pytest.raises(ValueError, match=match) as te:
        tzoo.expand_zoo(spec)
    with pytest.raises(ValueError) as je:
        jzoo.expand_zoo(spec)
    assert str(te.value) == str(je.value)


def test_register_family_checks_names_and_sources():
    fam = tzoo.get_family("wedge")
    with pytest.raises(ValueError, match="already registered"):
        tzoo.register_family(fam)
    with pytest.raises(ValueError, match="invalid source"):
        tzoo.register_family(dataclasses.replace(fam, name="x-bad",
                                                 sources=("bogus",)))
    assert "x-bad" not in tzoo.family_names()
