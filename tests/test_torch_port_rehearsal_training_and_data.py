"""The CPU rehearsal of chip_smoke.py's phases for the FlowFormerCov trainer and
the user's data layouts (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"training_and_data": ("train", "datasets")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
