"""The CPU rehearsal of chip_smoke.py is split into groups of phases, one
``test_torch_port_rehearsal_<group>.py`` a group (``tests/rehearsal.py``):
together they rehearse every phase of the full run once."""

import importlib.util
from pathlib import Path

from rehearsal import GROUP_FILES


def test_rehearsal_groups_hold_every_phase_of_the_full_run_once():
    import chip_smoke

    groups = {}
    for path in sorted(Path(__file__).parent.glob(GROUP_FILES)):
        spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert not set(groups) & set(module.GROUP), path.name
        groups.update(module.GROUP)
    assert len(groups) == 7 and "chain" in groups
    grouped = [phase for phases in groups.values() for phase in phases]
    assert len(grouped) == len(set(grouped))
    assert set(grouped) == set(chip_smoke.PHASES)
