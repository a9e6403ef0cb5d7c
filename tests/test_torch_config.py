"""The port's copy of the config reads the repo's YAML and environment
overrides as the reference does: every section, ``to_dict`` included."""

import dataclasses
from pathlib import Path

import pytest

from arxiv_rag_tpu.config import load_config as jax_load_config

from arxiv_rag_tpu_torch.config import load_config

DEFAULT_YAML = Path(__file__).resolve().parents[1] / "configs" / "default.yaml"


@pytest.mark.parametrize("yaml_path", [None, DEFAULT_YAML])
def test_sections_equal_the_reference(yaml_path):
    env = {"ARAG__RETRIEVAL__TOP_K": "7", "ARAG__EMBEDDING__LENGTH_BUCKETS": "32,64",
           "ARAG__PROCESSING__NUM_WORKERS": "3"}
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
        load_config(overrides={"no_such_section.root": "x"}, environ={})


@pytest.mark.parametrize("yaml_path", [None, DEFAULT_YAML])
def test_whole_config_equals_the_reference(yaml_path):
    """Every section, read from ``configs/default.yaml`` whole (or from the
    defaults), with overrides of the pipeline's sections: ``to_dict`` is
    the reference's."""
    env = {"ARAG__CHUNKING__METHOD": "semantic", "ARAG__TEXT__OVERLAP_CHARS": "300",
           "ARAG__EXTRACTION__BACKENDS": "pdftext,pypdf", "ARAG__PATHS__ROOT": "/x",
           "ARAG__PROCESSING__NUM_WORKERS": "2", "ARAG__LOGGING__JSON_LINES": "yes"}
    over = {"chunking.semantic_threshold": 0.5, "mesh.data_axis": 4}
    ours = load_config(yaml_path, overrides=over, environ=env)
    theirs = jax_load_config(yaml_path, overrides=over, environ=env)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.chunking.method == "semantic" and ours.extraction.backends == ("pdftext", "pypdf")
    assert ours.paths.resolve("corpus_dir") == theirs.paths.resolve("corpus_dir") == \
        Path("/x/corpus")
