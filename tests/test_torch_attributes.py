"""Attributes on the PyTorch port's ``Database`` against the JAX package.

The same seed gives both packages the same vector ids, so the same calls
go to a port database and a JAX database built from the same rows:
``get_attribute`` and ``set_attribute_at`` must return the same values
and raise :class:`InvalidArgs` with the same text. The port's copy of
``check_attribute_value`` is held against the original value by value.
"""

import uuid

import numpy as np
import pytest

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from flechasdb_tpu import attributes as jattributes
from flechasdb_tpu import errors as jerrors
from flechasdb_tpu_torch import attributes, errors


def _pair():
    x = np.random.default_rng(5).standard_normal((80, 8)).astype(np.float32)

    def build(pkg, **kw):
        return (pkg.DatabaseBuilder(x, **kw).with_partitions(4)
                .with_divisions(2).with_clusters(4).with_seed(21).build())
    db, jdb = build(ft, device="cpu"), build(fdb)
    assert db.vector_ids == jdb.vector_ids
    return db, jdb


def test_get_and_set_give_the_jax_values():
    db, jdb = _pair()
    sets = [(0, ("label", "first")), (0, ("count", 7)), (5, (3, 2**64 - 1)),
            (79, ("label", "")), (0, ("label", "again"))]
    for i, attr in sets:
        assert db.set_attribute_at(i, attr) is None
        jdb.set_attribute_at(i, attr)
    assert db.attribute_table == jdb.attribute_table
    for i in (0, 5, 79):
        vid = db.vector_ids[i]
        for key in ("label", "count", "3", "missing"):
            assert db.get_attribute(vid, key) == jdb.get_attribute(vid, key)
    assert db.get_attribute(db.vector_ids[0], "label") == "again"
    assert db.get_attribute(db.vector_ids[5], "3") == 2**64 - 1


def _raises_alike(mine, ref, cls=errors.InvalidArgs,
                  jcls=jerrors.InvalidArgs):
    with pytest.raises(cls) as got:
        mine()
    with pytest.raises(jcls) as want:
        ref()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["unknown_id", "id_without_attributes",
                                  "negative_index", "index_n", "bad_value"])
def test_attribute_errors_match_jax(case):
    db, jdb = _pair()
    n = db.num_vectors
    if case == "unknown_id":
        vid = uuid.UUID(int=12345)
        _raises_alike(lambda: db.get_attribute(vid, "k"),
                      lambda: jdb.get_attribute(vid, "k"))
    elif case == "id_without_attributes":
        vid = db.vector_ids[2]
        _raises_alike(lambda: db.get_attribute(vid, "k"),
                      lambda: jdb.get_attribute(vid, "k"))
    elif case == "negative_index":
        _raises_alike(lambda: db.set_attribute_at(-1, ("k", "v")),
                      lambda: jdb.set_attribute_at(-1, ("k", "v")))
    elif case == "index_n":
        _raises_alike(lambda: db.set_attribute_at(n, ("k", "v")),
                      lambda: jdb.set_attribute_at(n, ("k", "v")))
    else:
        _raises_alike(lambda: db.set_attribute_at(0, ("k", -3)),
                      lambda: jdb.set_attribute_at(0, ("k", -3)))
        assert db.attribute_table == jdb.attribute_table == {}


@pytest.mark.parametrize("value", ["text", 0, 2**64 - 1, 2**64, -1, True,
                                   1.5, None],
                         ids=["str", "zero", "u64_max", "u64_max_plus_1",
                              "negative", "bool", "float", "none"])
def test_check_attribute_value_copy_matches_the_original(value):
    try:
        want = jattributes.check_attribute_value(value)
    except jerrors.InvalidArgs as e:
        with pytest.raises(errors.InvalidArgs) as got:
            attributes.check_attribute_value(value)
        assert str(got.value) == str(e)
    else:
        got = attributes.check_attribute_value(value)
        assert got is want


def test_attribute_types_match_the_original():
    assert attributes.AttributeValue == jattributes.AttributeValue
    assert attributes.Attributes == jattributes.Attributes
    assert attributes.AttributeTable == jattributes.AttributeTable
    assert attributes._U64_MAX == jattributes._U64_MAX
    assert ft.AttributeValue is attributes.AttributeValue
