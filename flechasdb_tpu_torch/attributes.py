"""Vector attributes (the JAX package's ``attributes.py``, ``db.rs:14-45``).

Values are strings or unsigned 64-bit ints; an ``Attributes`` map holds one
vector's attributes and an ``AttributeTable`` maps vector UUIDs to them.
The port keeps its own copy: the JAX package's module sits behind that
package's ``__init__``, which imports jax. ``tests/test_torch_attributes.py``
holds this copy against the original.
"""

from __future__ import annotations

import uuid as _uuid
from typing import Dict, Union

from .errors import InvalidArgs

#: A string or an unsigned 64-bit integer (``db.rs:14-27``).
AttributeValue = Union[str, int]

#: One vector's attributes (``db.rs:41``).
Attributes = Dict[str, AttributeValue]

#: All attributes in a database, keyed by vector UUID (``db.rs:44``).
AttributeTable = Dict[_uuid.UUID, Attributes]

_U64_MAX = (1 << 64) - 1


def check_attribute_value(value: AttributeValue) -> AttributeValue:
    """Returns ``value`` unchanged if it is a str or an int that fits in
    ``uint64`` (the wire type, ``database.proto:88-93``); raises
    :class:`InvalidArgs` otherwise. ``bool`` is refused, though Python
    counts it an int."""
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        raise InvalidArgs("attribute value must be str or non-negative int")
    if isinstance(value, int):
        if value < 0 or value > _U64_MAX:
            raise InvalidArgs(
                f"integer attribute must fit in uint64, got {value}"
            )
        return value
    raise InvalidArgs(
        f"attribute value must be str or int, got {type(value).__name__}"
    )
