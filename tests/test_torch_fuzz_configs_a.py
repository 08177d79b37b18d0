"""Seeds 0-5 of ``tests/test_fuzz_configs.py``'s random tool combinations
through the port on the CPU: each stream equals the JAX host stream byte
for byte and decodes, by the port's decoder, to the port's recon
(``tests/torch_fuzz_cases.py``)."""

import pytest

from tests.torch_fuzz_cases import check_seed
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(6))
def test_random_tool_combination_equals_jax(seed):
    check_seed(seed)
