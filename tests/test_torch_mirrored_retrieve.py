"""The JAX package's own tests of batch_retrieve, embed_pipeline and store run against the port
as they stand, on the CPU (see ``tests/test_torch_mirrored_api.py``)."""

import sys

import pytest

from torch_parity import (
    assert_mirrored_against_the_port,
    mirror_files,
    port_store,  # noqa: F401  (fixture)
)

STEMS = ('batch_retrieve', 'embed_pipeline', 'store')


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_files(globals(), STEMS)


def test_the_mirrored_tests_ran_against_the_port():
    assert sys.modules[f"{__name__}.{STEMS[0]}"]
    assert_mirrored_against_the_port(__name__, STEMS)
