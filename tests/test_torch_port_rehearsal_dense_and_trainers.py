"""The CPU rehearsal of chip_smoke.py's phases for the dense evaluation,
TartanVO-cov and the TartanVO trainer (``tests/rehearsal.py``)."""

import pytest

from rehearsal import rehearse

GROUP = {"dense_and_trainers": ("dense", "tartanvo_cov", "train_tvo")}


@pytest.mark.parametrize("group", GROUP)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    rehearse(GROUP[group])
