"""The port's copies of the JAX package's generated tables: each ``.npz``
holds the same keys and byte-equal arrays. The ``tools/extract_*.py``
scripts that made them read the reference C tree and stay with the JAX
package; this test stands in for them on the port's side."""

from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TABLES = ["ops/data/txfm_networks.npz", "ops/data/grain_tables.npz",
          "pipeline/data/avail_tables.npz", "entropy/data/default_cdfs.npz",
          "verify/data/indep_tables.npz"]


@pytest.mark.parametrize("rel", TABLES)
def test_port_table_equals_the_jax_packages(rel):
    with np.load(REPO / "svt_av1_tpu" / rel) as jax_t, \
            np.load(REPO / "svt_av1_tpu_torch" / rel) as port_t:
        assert sorted(port_t.files) == sorted(jax_t.files)
        assert jax_t.files
        for k in jax_t.files:
            a, b = jax_t[k], port_t[k]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), k
            assert a.tobytes() == b.tobytes(), k
