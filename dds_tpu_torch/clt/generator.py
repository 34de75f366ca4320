"""Workload generator: proportions -> shuffled, schema-aware instruction queue.

Copy of `dds_tpu/clt/generator.py`, the counterpart of
`clt/DDSDataGenerator.scala:31-269`: each operation count is
round(n * proportion); operations only target columns whose encryption
scheme supports them (Sum needs a PSSE column, range search an OPE column,
entry search an LSE column, ... — the canonical table at
`DDSDataGenerator.scala:11-23`); rows have a fixed encrypted prefix plus a
random-length plaintext-typed tail. Every `rng` call is in the
reference's order, so one seed gives the same instruction list in both
packages.

Fixed vs the original system (as in the reference): Mult/MultAll counts
use the mult proportions (the original reuses the sum-all count,
`:159-171`), and SearchEntryOR uses its own count (the original reuses
search-entry's, `:253`).
"""

from __future__ import annotations

import random
from typing import Iterable

from dds_tpu_torch.clt import instructions as I

# value/row distributions live in clt/distribution, as in the reference;
# re-exported here under the reference's names
from dds_tpu_torch.clt.distribution import (  # noqa: F401  (re-exports)
    ALLOWED_DATA_TYPES,
    generate_column_data,
    random_row,
)

DEFAULT_PROPORTIONS = {
    "get-set": 0.0, "put-set": 0.1, "remove-set": 0.0, "add-element": 0.0,
    "read-element": 0.0, "write-element": 0.0, "is-element": 0.0,
    "sum": 0.0, "sum-all": 0.0, "mult": 0.0, "mult-all": 0.0,
    "search-eq": 0.1, "search-neq": 0.1, "search-gt": 0.1, "search-gteq": 0.1,
    "search-lt": 0.1, "search-lteq": 0.1, "order-ls": 0.0, "order-sl": 0.0,
    "search-entry": 0.1, "search-entry-and": 0.1, "search-entry-or": 0.1,
}


def _columns_by_scheme(schema: list[str]) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {s: [] for s in ("OPE", "CHE", "LSE", "PSSE", "MSE", "None")}
    for i, s in enumerate(schema):
        out.setdefault(s, []).append(i)
    return out


def generate(
    nr_of_operations: int,
    proportions: dict[str, float] | None = None,
    max_nr_of_columns: int = 16,
    column_mappings: list[str] | None = None,
    column_encryptions: list[str] | None = None,
    rng: random.Random | None = None,
) -> list:
    """Build the shuffled instruction list for one client run."""
    rng = rng or random.Random()
    if proportions is None:
        props = dict(DEFAULT_PROPORTIONS)
    else:
        unknown = set(proportions) - set(DEFAULT_PROPORTIONS)
        if unknown:
            raise ValueError(f"unknown proportion keys: {sorted(unknown)}")
        # user distribution REPLACES the defaults: unspecified ops are 0,
        # so nr_of_operations matches the requested mix
        props = {k: proportions.get(k, 0.0) for k in DEFAULT_PROPORTIONS}
    mappings = column_mappings or ["Int", "String", "Int", "Int", "String", "String", "String", "Blob"]
    schema = column_encryptions or ["OPE", "CHE", "PSSE", "MSE", "CHE", "CHE", "CHE", "None"]
    cols = _columns_by_scheme(schema)
    fixed = len(schema)

    def count(op: str) -> int:
        return round(nr_of_operations * props.get(op, 0.0))

    def rand_row() -> list:
        return random_row(mappings[:fixed], max_nr_of_columns, rng)

    def pick(scheme_cols: Iterable[str]) -> list[int]:
        merged: list[int] = []
        for s in scheme_cols:
            merged.extend(cols.get(s, []))
        return merged

    out: list = []
    out += [I.PutSet(rand_row()) for _ in range(count("put-set"))]
    out += [I.GetSet() for _ in range(count("get-set"))]
    out += [I.RemoveSet() for _ in range(count("remove-set"))]
    out += [I.AddElement(generate_column_data("String", rng)) for _ in range(count("add-element"))]
    out += [
        I.WriteElem(generate_column_data("String", rng), fixed + rng.randrange(4))
        for _ in range(count("write-element"))
    ]
    out += [I.ReadElem(rng.randrange(fixed)) for _ in range(count("read-element"))]

    che = pick(["CHE"])
    out += [
        I.IsElement(generate_column_data("String", rng))
        for _ in range(count("is-element"))
        if che
    ]

    psse, mse, ope, lse = pick(["PSSE"]), pick(["MSE"]), pick(["OPE"]), pick(["LSE"])
    if psse:
        out += [I.Sum(rng.choice(psse)) for _ in range(count("sum"))]
        out += [I.SumAll(rng.choice(psse)) for _ in range(count("sum-all"))]
    if mse:
        out += [I.Mult(rng.choice(mse)) for _ in range(count("mult"))]
        out += [I.MultAll(rng.choice(mse)) for _ in range(count("mult-all"))]
    eq_cols = ope + che
    if eq_cols:
        for op, n in ((I.SearchEq, count("search-eq")), (I.SearchNEq, count("search-neq"))):
            for _ in range(n):
                pos = rng.choice(eq_cols)
                ctype = mappings[pos] if schema[pos] == "OPE" else "String"
                out.append(op(pos, generate_column_data(ctype, rng)))
    if ope:
        for op, n in (
            (I.SearchGt, count("search-gt")),
            (I.SearchGtEq, count("search-gteq")),
            (I.SearchLt, count("search-lt")),
            (I.SearchLtEq, count("search-lteq")),
        ):
            out += [op(rng.choice(ope), generate_column_data("Int", rng)) for _ in range(n)]
        out += [I.OrderLS(rng.choice(ope)) for _ in range(count("order-ls"))]
        out += [I.OrderSL(rng.choice(ope)) for _ in range(count("order-sl"))]
    if lse:
        word = lambda: generate_column_data("String", rng)
        out += [I.SearchEntry(word()) for _ in range(count("search-entry"))]
        out += [
            I.SearchEntryOR(word(), word(), word()) for _ in range(count("search-entry-or"))
        ]
        out += [
            I.SearchEntryAND(word(), word(), word())
            for _ in range(count("search-entry-and"))
        ]

    rng.shuffle(out)
    return out
