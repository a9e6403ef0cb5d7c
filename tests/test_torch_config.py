"""The port's copy of the embedding / index / retrieval config sections
reads the repo's YAML and environment overrides as the reference does."""

import dataclasses
from pathlib import Path

import pytest

from arxiv_rag_tpu.config import load_config as jax_load_config

from arxiv_rag_tpu_torch.config import load_config

DEFAULT_YAML = Path(__file__).resolve().parents[1] / "configs" / "default.yaml"


@pytest.mark.parametrize("yaml_path", [None, DEFAULT_YAML])
def test_sections_equal_the_reference(yaml_path):
    env = {"ARAG__RETRIEVAL__TOP_K": "7", "ARAG__EMBEDDING__LENGTH_BUCKETS": "32,64",
           "ARAG__PROCESSING__NUM_WORKERS": "3"}  # a section the port does not read
    ours = load_config(yaml_path, overrides={"index.dtype": "int8"}, environ=env)
    theirs = jax_load_config(yaml_path, overrides={"index.dtype": "int8"}, environ=env)
    for name in ("embedding", "index", "retrieval"):
        assert dataclasses.asdict(getattr(ours, name)) == \
               dataclasses.asdict(getattr(theirs, name))
    assert ours.retrieval.top_k == 7 and ours.embedding.length_buckets == (32, 64)


def test_unknown_keys_are_loud():
    with pytest.raises(KeyError):
        load_config(environ={"ARAG__RETRIEVAL__NO_SUCH_KNOB": "1"})
    with pytest.raises(KeyError):
        load_config(overrides={"paths.root": "x"}, environ={})
