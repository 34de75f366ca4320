"""The workload generator and its distributions against the reference's.

`dds_tpu_torch.clt.{generator,distribution}` are copies of
`dds_tpu/clt/{generator,distribution}.py`: one seed must give the same
instruction list, the same rows and the same values in both packages, for
the generator's default mix, `configs/default.toml`'s `[client.proportions]`
and `benchmarks/mixed.py`'s `MIX`, and an unknown proportion key must raise
the same error. Instructions are compared by kind and fields (each package
has its own dataclasses). Exact equality throughout.
"""

import dataclasses
import random
import tomllib
from pathlib import Path

import pytest

from benchmarks.mixed import MIX
from dds_tpu.clt import distribution as ref_dist
from dds_tpu.clt import generator as ref_gen
from dds_tpu_torch.clt import distribution, generator

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_TOML = tomllib.loads((ROOT / "configs" / "default.toml").read_text())
MIXES = {
    "default": None,
    "default.toml": DEFAULT_TOML["client"]["proportions"],
    "mixed.py": MIX,
}


def _kinds(instrs: list) -> list:
    return [(type(i).__name__, dataclasses.astuple(i)) for i in instrs]


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_generate_gives_the_reference_instruction_list(mix, seed):
    got = generator.generate(200, MIXES[mix], rng=random.Random(seed))
    want = ref_gen.generate(200, MIXES[mix], rng=random.Random(seed))
    assert got and _kinds(got) == _kinds(want)


def test_generate_with_another_schema_and_width():
    schema = ["OPE", "LSE", "PSSE", "MSE", "CHE", "LSE"]
    mappings = ["Int", "String", "Int", "Int", "String", "String"]
    props = dict.fromkeys(generator.DEFAULT_PROPORTIONS, 1 / 22)
    got = generator.generate(330, props, 10, mappings, schema, rng=random.Random(5))
    want = ref_gen.generate(330, props, 10, mappings, schema, rng=random.Random(5))
    assert _kinds(got) == _kinds(want)
    assert {k for k, _ in _kinds(got)} >= {"SearchEntry", "SearchEntryOR", "SearchEntryAND",
                                          "WriteElem", "MultAll", "OrderLS", "IsElement"}


def test_unknown_proportion_keys_raise_the_reference_error():
    bad = {"put-set": 0.5, "sum-everything": 0.5, "bogus": 0.1}
    with pytest.raises(ValueError) as got:
        generator.generate(10, bad, rng=random.Random(0))
    with pytest.raises(ValueError) as want:
        ref_gen.generate(10, bad, rng=random.Random(0))
    assert str(got.value) == str(want.value)
    assert generator.DEFAULT_PROPORTIONS == ref_gen.DEFAULT_PROPORTIONS


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_row_and_column_data_match_the_reference(seed):
    mappings = ["Int", "String", "Int", "Int", "String", "String", "String", "Blob"]
    rng, ref_rng = random.Random(seed), random.Random(seed)
    rows = [distribution.random_row(mappings, 16, rng) for _ in range(20)]
    assert rows == [ref_dist.random_row(mappings, 16, ref_rng) for _ in range(20)]
    for ctype in distribution.ALLOWED_DATA_TYPES:
        assert (distribution.generate_column_data(ctype, rng)
                == ref_dist.generate_column_data(ctype, ref_rng))
    assert generator.random_row is distribution.random_row


def test_zipf_keys_match_the_reference():
    keys = [f"k{i}" for i in range(50)]
    z = distribution.ZipfKeys(keys, 1.1, random.Random(2))
    rz = ref_dist.ZipfKeys(keys, 1.1, random.Random(2))
    assert [z.pick() for _ in range(500)] == [rz.pick() for _ in range(500)]
    assert [z.weight(r) for r in (1, 2, 50)] == [rz.weight(r) for r in (1, 2, 50)]
    with pytest.raises(ValueError, match="at least one key"):
        distribution.ZipfKeys([])
