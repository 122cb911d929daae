"""Unit vocabulary for the pricing core (DESIGN.md §12).

Every quantity the cost model prices — seconds, cycles, bytes, elements,
flops, die mm², dollars, watts — gets a zero-runtime-cost type alias:

    Seconds = Annotated[float, Unit(s=1)]

The ``Unit`` metadata is a dimension vector over the base dimensions below,
with the obvious algebra (exponents add under ``*``, subtract under ``/``):

    Bytes / BytesPerSecond  -> Seconds
    Cycles / Hertz          -> Seconds          (Hertz is cycles/second)
    Elements * BytesPerElement -> Bytes
    Seconds + Bytes         -> dimension error  (caught by core/unitcheck.py)

Annotations are erased at runtime (``Annotated[float, ...]`` IS ``float`` to
the interpreter and to dataclasses), so annotating the pricing core changes
no numbers — the fp16 default path stays bit-for-bit against
``tests/data/seed_reference.json``. The static pass in core/unitcheck.py
reads these aliases from signatures, dataclass fields and ``x: Unit`` local
declarations and propagates them through arithmetic; anything unannotated is
``ANY`` and never produces a diagnostic (gradual typing: the checker proves
exactly what is annotated).

Conventions (how to annotate new pricing code):
  * totals are ``Bytes`` / ``Flops`` / ``Elements``; *per-element* widths and
    rates are ``BytesPerElement`` / ``FlopsPerElement`` (so ``n * bytes_elt``
    is provably ``Bytes`` only when ``n`` is ``Elements``);
  * tensor extents (m, k, n, rows, cols, batch) stay plain ``int`` — their
    products become ``Elements`` at an annotated local, e.g.
    ``n: Elements = rows * cols``;
  * frequencies are ``Hertz`` (cycles/second): dividing a cycle count by a
    frequency, or a byte count by a bandwidth, provably yields Seconds.
"""
from __future__ import annotations

from typing import Annotated, Dict, Tuple

#: base dimensions, canonical order (time, clock ticks, information,
#: tensor elements, float operations, die area, money, power)
DIMENSIONS = ("s", "cycle", "byte", "elt", "flop", "mm2", "usd", "watt")


class Unit:
    """An immutable dimension vector: ``Unit(byte=1, s=-1)`` is bytes/second.

    Supports ``*``, ``/`` and integer ``**`` (exponents add / subtract /
    scale). Equality and hashing are structural, so Units are usable as dict
    keys and inside ``Annotated`` metadata.
    """

    __slots__ = ("dims",)

    dims: Tuple[Tuple[str, int], ...]

    def __init__(self, **exponents: int) -> None:
        bad = set(exponents) - set(DIMENSIONS)
        if bad:
            raise ValueError(f"unknown dimension(s) {sorted(bad)}; "
                             f"have {DIMENSIONS}")
        object.__setattr__(self, "dims", tuple(
            (d, int(e)) for d, e in sorted(exponents.items()) if e))

    @classmethod
    def _from_dims(cls, dims: Dict[str, int]) -> "Unit":
        u = object.__new__(cls)
        object.__setattr__(u, "dims", tuple(
            (d, e) for d, e in sorted(dims.items()) if e))
        return u

    def __setattr__(self, name: str, value: object) -> None:
        raise AttributeError("Unit is immutable")

    def exponent(self, dim: str) -> int:
        return dict(self.dims).get(dim, 0)

    # ---- algebra ---------------------------------------------------------
    def __mul__(self, other: "Unit") -> "Unit":
        if not isinstance(other, Unit):
            raise TypeError(f"cannot multiply Unit by {type(other).__name__}")
        out = dict(self.dims)
        for d, e in other.dims:
            out[d] = out.get(d, 0) + e
        return Unit._from_dims(out)

    def __truediv__(self, other: "Unit") -> "Unit":
        if not isinstance(other, Unit):
            raise TypeError(f"cannot divide Unit by {type(other).__name__}")
        out = dict(self.dims)
        for d, e in other.dims:
            out[d] = out.get(d, 0) - e
        return Unit._from_dims(out)

    def __pow__(self, k: int) -> "Unit":
        if not isinstance(k, int):
            raise TypeError("Unit exponents are integers")
        return Unit._from_dims({d: e * k for d, e in self.dims})

    # ---- identity --------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return isinstance(other, Unit) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    @property
    def dimensionless(self) -> bool:
        return not self.dims

    @property
    def symbol(self) -> str:
        """Human-readable form: ``B·s^-1``, ``1`` for dimensionless."""
        if not self.dims:
            return "1"
        sym = {"s": "s", "cycle": "cyc", "byte": "B", "elt": "elt",
               "flop": "flop", "mm2": "mm2", "usd": "$", "watt": "W"}
        return "·".join(f"{sym[d]}" + (f"^{e}" if e != 1 else "")
                        for d, e in self.dims)

    def __repr__(self) -> str:
        return f"Unit({self.symbol})"


DIMENSIONLESS = Unit()

# ---------------------------------------------------------------------------
# the vocabulary: zero-runtime-cost aliases (Annotated[float, Unit(...)])
# ---------------------------------------------------------------------------

Ratio = Annotated[float, Unit()]        # provably-dimensionless fractions
Seconds = Annotated[float, Unit(s=1)]
Cycles = Annotated[float, Unit(cycle=1)]
Bytes = Annotated[float, Unit(byte=1)]
Elements = Annotated[float, Unit(elt=1)]
Flops = Annotated[float, Unit(flop=1)]
Mm2 = Annotated[float, Unit(mm2=1)]
Dollars = Annotated[float, Unit(usd=1)]
Watts = Annotated[float, Unit(watt=1)]

Hertz = Annotated[float, Unit(cycle=1, s=-1)]           # cycles / second
PerSecond = Annotated[float, Unit(s=-1)]                # rates (tokens/s)
BytesPerSecond = Annotated[float, Unit(byte=1, s=-1)]
FlopsPerSecond = Annotated[float, Unit(flop=1, s=-1)]
BytesPerCycle = Annotated[float, Unit(byte=1, cycle=-1)]
FlopsPerCycle = Annotated[float, Unit(flop=1, cycle=-1)]
BytesPerElement = Annotated[float, Unit(byte=1, elt=-1)]
FlopsPerElement = Annotated[float, Unit(flop=1, elt=-1)]

#: alias-name -> Unit registry read by the static checker to resolve
#: annotations in source (``x: Seconds``, ``def f() -> Bytes``, field decls)
ALIASES: Dict[str, Unit] = {
    "Ratio": Unit(),
    "Seconds": Unit(s=1),
    "Cycles": Unit(cycle=1),
    "Bytes": Unit(byte=1),
    "Elements": Unit(elt=1),
    "Flops": Unit(flop=1),
    "Mm2": Unit(mm2=1),
    "Dollars": Unit(usd=1),
    "Watts": Unit(watt=1),
    "Hertz": Unit(cycle=1, s=-1),
    "PerSecond": Unit(s=-1),
    "BytesPerSecond": Unit(byte=1, s=-1),
    "FlopsPerSecond": Unit(flop=1, s=-1),
    "BytesPerCycle": Unit(byte=1, cycle=-1),
    "FlopsPerCycle": Unit(flop=1, cycle=-1),
    "BytesPerElement": Unit(byte=1, elt=-1),
    "FlopsPerElement": Unit(flop=1, elt=-1),
}


def unit_of(alias: object) -> Unit:
    """The Unit metadata of an ``Annotated[float, Unit(...)]`` alias."""
    meta = getattr(alias, "__metadata__", ())
    for m in meta:
        if isinstance(m, Unit):
            return m
    raise TypeError(f"{alias!r} carries no Unit metadata")
