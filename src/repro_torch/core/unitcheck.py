"""AST dimensional-analysis pass over the pricing core (DESIGN.md §12).

The static verifier (core/verify.py) validates runtime values; this pass
makes *unit* errors unrepresentable at lint time. It reads the
``Annotated[float, Unit(...)]`` aliases from core/units.py wherever they
appear in source — function signatures, dataclass fields,
``x: Seconds = ...`` locals, module constants — and propagates dimension
vectors through arithmetic, assignments, calls, constructor keywords,
attribute loads/stores and returns, emitting
``verify.Diagnostic`` records (rule id, severity, file:line, fix hint) when
two provably-different dimensions meet where they must agree.

The inference is *gradual*: every expression is one of

  * ``ANY``            — unit unknown (unannotated names, containers, numpy
                         internals). Absorbing under ``*``/``/``; optimistic
                         under ``+`` (the result takes the known side).
                         ANY never produces a diagnostic, so unannotated
                         code is silent by construction.
  * ``DIMENSIONLESS``  — numeric literals and ``Ratio``-typed values.
                         Coerces to any unit (this is how constants enter:
                         ``FP32_BYTES: BytesPerElement = 4.0``).
  * a known ``Unit``   — traced from an alias annotation through the
                         dimension algebra (``Bytes / BytesPerSecond`` is
                         ``Seconds``; ``Elements * BytesPerElement`` is
                         ``Bytes``).

Only when BOTH sides of an addition/comparison/assignment/field-store/
return carry known, different, non-dimensionless units does a rule fire —
the checker proves exactly what the annotations claim, nothing more.

Rules (all error severity):

  unit.add-mismatch      operands of + / - / += / max / min disagree
  unit.compare-mismatch  comparison operands disagree
  unit.assign-mismatch   value disagrees with an ``x: Unit`` declaration
  unit.field-mismatch    constructor kwarg / replace() kwarg / attribute
                         store disagrees with the declared field unit
  unit.return-mismatch   returned expression disagrees with ``-> Unit``
  unit.call-mismatch     argument disagrees with the declared param unit

Two passes: pass 1 over every target file builds global symbol tables
(class fields & properties, function signatures, module constants — merged
by bare name across the tree, matching the from-import style of the core);
pass 2 walks each function body linearly (both branches of ``if``, loop
bodies once) inferring an environment of name -> (unit, class) and checking
every rule site. ``check_source`` runs the same engine on a standalone
snippet, which is how the planted-mutant suite proves each rule fires.

The PyTorch port's copy of the JAX package's engine, whole: over the same
sources it gives the same diagnostics (tests/test_torch_unitcheck.py).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .units import ALIASES, DIMENSIONLESS, Unit
from .verify import Diagnostic

__all__ = [
    "RULES", "Rule", "check_paths", "check_sources", "check_source",
    "registry_diagnostics", "registry_selfcheck", "DEFAULT_TARGETS",
]

#: the pricing core this pass was built to police (relative to
#: src/repro_torch)
DEFAULT_TARGETS = ("core",)


# ---------------------------------------------------------------------------
# rule registry (mirrors verify.RULES so CI modes / docs treat them alike)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rule:
    rule_id: str
    summary: str


RULES: Dict[str, Rule] = {}


def _rule(rule_id: str, summary: str) -> str:
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id!r}")
    RULES[rule_id] = Rule(rule_id, summary)
    return rule_id


ADD_MISMATCH = _rule(
    "unit.add-mismatch",
    "operands of +, -, += or max/min carry different dimensions")
COMPARE_MISMATCH = _rule(
    "unit.compare-mismatch",
    "comparison operands carry different dimensions")
ASSIGN_MISMATCH = _rule(
    "unit.assign-mismatch",
    "assigned value disagrees with the local's declared unit")
FIELD_MISMATCH = _rule(
    "unit.field-mismatch",
    "value stored into a dataclass field disagrees with its declared unit")
RETURN_MISMATCH = _rule(
    "unit.return-mismatch",
    "returned expression disagrees with the declared return unit")
CALL_MISMATCH = _rule(
    "unit.call-mismatch",
    "argument disagrees with the declared parameter unit")


# ---------------------------------------------------------------------------
# inference values
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Val:
    """Inference result for one expression: dimension + (optional) class.

    ``unit is None`` means ANY. ``cls`` names a class from the symbol
    tables when the expression is an instance of it (used to resolve
    ``obj.field`` chains and ``replace(obj, ...)``).
    """
    unit: Optional[Unit] = None
    cls: Optional[str] = None
    elts: Optional[Tuple["Val", ...]] = None   # tuple literals, for returns


ANY = Val()
SCALAR = Val(unit=DIMENSIONLESS)


def _known(v: Val) -> bool:
    return v.unit is not None and not v.unit.dimensionless


# ---------------------------------------------------------------------------
# annotation resolution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ann:
    """A resolved source annotation: unit alias, class reference, or both
    unknown (ANY)."""
    unit: Optional[Unit] = None
    cls: Optional[str] = None
    elts: Optional[Tuple["Ann", ...]] = None   # Tuple[Seconds, Flops] returns


ANN_ANY = Ann()


@dataclass
class FuncInfo:
    name: str
    params: List[Tuple[str, Ann]]          # positional-or-keyword, in order
    kwonly: Dict[str, Ann]
    ret: Ann
    is_method: bool = False                # first param is self/cls


@dataclass
class ClassInfo:
    name: str
    fields: Dict[str, Ann]                 # AnnAssign fields + @property rets
    order: List[str]                       # declaration order (ctor mapping)
    methods: Dict[str, FuncInfo]


class SymbolTables:
    """Pass-1 product: bare-name-merged classes / functions / constants."""

    def __init__(self) -> None:
        self.classes: Dict[str, ClassInfo] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self.consts: Dict[str, Val] = {}
        # field name -> Ann agreed on by every class declaring it with a
        # known unit; None if two classes disagree ("duck" field lookup for
        # attribute loads whose base class is unknown)
        self.duck: Dict[str, Optional[Ann]] = {}

    def resolve(self, node: Optional[ast.expr]) -> Ann:
        """Resolve an annotation AST node to (unit, class)."""
        if node is None:
            return ANN_ANY
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                node = ast.parse(node.value, mode="eval").body
            except SyntaxError:
                return ANN_ANY
        if isinstance(node, ast.Name):
            return self._resolve_name(node.id)
        if isinstance(node, ast.Attribute):
            return self._resolve_name(node.attr)
        if isinstance(node, ast.Subscript):
            head = node.value
            head_name = (head.id if isinstance(head, ast.Name)
                         else head.attr if isinstance(head, ast.Attribute)
                         else "")
            if head_name == "Optional":
                return self.resolve(node.slice)
            if head_name == "Tuple" or head_name == "tuple":
                if isinstance(node.slice, ast.Tuple):
                    elts = tuple(self.resolve(e) for e in node.slice.elts)
                    if any(e.unit is not None or e.cls for e in elts):
                        return Ann(elts=elts)
            return ANN_ANY
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
            # X | None style optionals
            left = self.resolve(node.left)
            right = self.resolve(node.right)
            if left is not ANN_ANY and right is ANN_ANY:
                return left
            if right is not ANN_ANY and left is ANN_ANY:
                return right
            return ANN_ANY
        return ANN_ANY

    def _resolve_name(self, name: str) -> Ann:
        if name in ALIASES:
            return Ann(unit=ALIASES[name])
        if name in self.classes:
            return Ann(cls=name)
        return ANN_ANY

    def build_duck(self) -> None:
        seen: Dict[str, Optional[Ann]] = {}
        for ci in self.classes.values():
            for fname, ann in ci.fields.items():
                if ann.unit is None and ann.cls is None:
                    continue                      # ANY declarations ignored
                if fname not in seen:
                    seen[fname] = ann
                elif seen[fname] is not None and seen[fname] != ann:
                    seen[fname] = None            # conflict -> ambiguous
        self.duck = seen


def _decorator_names(fn: ast.FunctionDef) -> List[str]:
    out = []
    for d in fn.decorator_list:
        if isinstance(d, ast.Name):
            out.append(d.id)
        elif isinstance(d, ast.Attribute):
            out.append(d.attr)
        elif isinstance(d, ast.Call):
            f = d.func
            out.append(f.id if isinstance(f, ast.Name)
                       else f.attr if isinstance(f, ast.Attribute) else "")
    return out


def _func_info(tables: SymbolTables, fn: ast.FunctionDef,
               is_method: bool = False) -> FuncInfo:
    decs = _decorator_names(fn)
    method = is_method and "staticmethod" not in decs
    params: List[Tuple[str, Ann]] = []
    for a in list(fn.args.posonlyargs) + list(fn.args.args):
        params.append((a.arg, tables.resolve(a.annotation)))
    kwonly = {a.arg: tables.resolve(a.annotation)
              for a in fn.args.kwonlyargs}
    return FuncInfo(fn.name, params, kwonly, tables.resolve(fn.returns),
                    is_method=method)


def _build_tables(modules: Dict[str, ast.Module]) -> SymbolTables:
    tables = SymbolTables()
    # round 1: class names must exist before annotations resolve to them
    for mod in modules.values():
        for node in mod.body:
            if isinstance(node, ast.ClassDef):
                tables.classes[node.name] = ClassInfo(node.name, {}, [], {})
    # round 2: fields, methods, functions, constants
    for mod in modules.values():
        for node in mod.body:
            if isinstance(node, ast.ClassDef):
                ci = tables.classes[node.name]
                for item in node.body:
                    if (isinstance(item, ast.AnnAssign)
                            and isinstance(item.target, ast.Name)):
                        ci.fields[item.target.id] = tables.resolve(
                            item.annotation)
                        ci.order.append(item.target.id)
                    elif isinstance(item, ast.FunctionDef):
                        fi = _func_info(tables, item, is_method=True)
                        ci.methods[item.name] = fi
                        if "property" in _decorator_names(item):
                            ci.fields[item.name] = fi.ret
            elif isinstance(node, ast.FunctionDef):
                tables.funcs[node.name] = _func_info(tables, node)
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                ann = tables.resolve(node.annotation)
                tables.consts[node.target.id] = Val(ann.unit, ann.cls)
    tables.build_duck()
    return tables


# ---------------------------------------------------------------------------
# per-function inference
# ---------------------------------------------------------------------------

#: calls that pass their first argument's unit through unchanged
_PASSTHROUGH = {"abs", "float", "int", "round", "ceil", "floor", "fabs",
                "trunc", "copy", "deepcopy", "asarray", "array", "sqrt0"}
#: calls whose arguments must share a unit and whose result is that unit
_UNIFYING = {"max", "min", "maximum", "minimum"}


class _Checker:
    def __init__(self, tables: SymbolTables, filename: str,
                 diags: List[Diagnostic]) -> None:
        self.tables = tables
        self.filename = filename
        self.diags = diags
        self.env: Dict[str, Val] = {}
        self.ret: Ann = ANN_ANY

    # ---- reporting -------------------------------------------------------
    def _diag(self, rule: str, node: ast.AST, message: str,
              hint: str = "") -> None:
        line = getattr(node, "lineno", 0)
        self.diags.append(Diagnostic(
            rule=rule, severity="error", message=message,
            location=f"{self.filename}:{line}", hint=hint))

    def _mismatch(self, rule: str, node: ast.AST, what: str,
                  left: Unit, right: Unit, hint: str = "") -> None:
        self._diag(rule, node,
                   f"{what}: {left.symbol} vs {right.symbol}",
                   hint or "annotate or convert one side so the "
                           "dimensions agree")

    # ---- entry points ----------------------------------------------------
    def check_function(self, fn: ast.FunctionDef,
                       cls: Optional[str] = None) -> None:
        info = (self.tables.classes[cls].methods[fn.name] if cls
                else self.tables.funcs.get(fn.name))
        if info is None:
            info = _func_info(self.tables, fn)
        self.env = {}
        self.ret = info.ret
        params = info.params
        if info.is_method and params:
            name, _ = params[0]
            self.env[name] = Val(cls=cls) if cls else ANY
            params = params[1:]
        for name, ann in params:
            self.env[name] = Val(ann.unit, ann.cls)
        for name, ann in info.kwonly.items():
            self.env[name] = Val(ann.unit, ann.cls)
        for stmt in fn.body:
            self._exec(stmt)

    def check_module_body(self, mod: ast.Module) -> None:
        """Module-level statements (constant declarations, init code)."""
        self.env = {}
        self.ret = ANN_ANY
        for stmt in mod.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Import, ast.ImportFrom)):
                continue
            self._exec(stmt)

    # ---- statements ------------------------------------------------------
    def _exec(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            val = self._infer(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, val, stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            ann = self.tables.resolve(stmt.annotation)
            if stmt.value is not None:
                val = self._infer(stmt.value)
                if (ann.unit is not None and not ann.unit.dimensionless
                        and _known(val) and val.unit != ann.unit):
                    self._mismatch(
                        ASSIGN_MISMATCH, stmt,
                        "declared unit disagrees with assigned value",
                        ann.unit, val.unit,  # type: ignore[arg-type]
                        hint="fix the expression or the declaration")
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = Val(
                    ann.unit, ann.cls if ann.cls else None)
            elif isinstance(stmt.target, ast.Attribute):
                self._store_attr(stmt.target,
                                 Val(ann.unit, ann.cls), stmt)
        elif isinstance(stmt, ast.AugAssign):
            cur = self._infer(stmt.target)
            val = self._infer(stmt.value)
            if isinstance(stmt.op, (ast.Add, ast.Sub)):
                out = self._add(cur, val, stmt)
            elif isinstance(stmt.op, ast.Mult):
                out = self._mul(cur, val)
            elif isinstance(stmt.op, (ast.Div, ast.FloorDiv)):
                out = self._div(cur, val)
            else:
                out = ANY
            if isinstance(stmt.target, ast.Name):
                # an annotated local keeps its declared unit
                prev = self.env.get(stmt.target.id, ANY)
                self.env[stmt.target.id] = prev if _known(prev) else out
        elif isinstance(stmt, ast.Return):
            self._check_return(stmt)
        elif isinstance(stmt, ast.If):
            self._infer(stmt.test)
            for s in stmt.body:
                self._exec(s)
            for s in stmt.orelse:
                self._exec(s)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._infer(stmt.iter)
            self._bind(stmt.target, ANY, stmt.iter)
            for s in stmt.body:
                self._exec(s)
            for s in stmt.orelse:
                self._exec(s)
        elif isinstance(stmt, ast.While):
            self._infer(stmt.test)
            for s in stmt.body:
                self._exec(s)
            for s in stmt.orelse:
                self._exec(s)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._infer(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, ANY, item.context_expr)
            for s in stmt.body:
                self._exec(s)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body:
                self._exec(s)
            for h in stmt.handlers:
                for s in h.body:
                    self._exec(s)
            for s in stmt.orelse:
                self._exec(s)
            for s in stmt.finalbody:
                self._exec(s)
        elif isinstance(stmt, ast.Expr):
            self._infer(stmt.value)
        elif isinstance(stmt, ast.Assert):
            self._infer(stmt.test)
        elif isinstance(stmt, ast.FunctionDef):
            # nested function: check with its own (closure-free) env
            saved_env, saved_ret = self.env, self.ret
            info = _func_info(self.tables, stmt)
            self.env = {}
            for name, ann in info.params:
                self.env[name] = Val(ann.unit, ann.cls)
            for name, ann in info.kwonly.items():
                self.env[name] = Val(ann.unit, ann.cls)
            self.ret = info.ret
            for s in stmt.body:
                self._exec(s)
            self.env, self.ret = saved_env, saved_ret
        # Raise / Pass / Delete / Global / Import / ClassDef: nothing priced

    def _bind(self, tgt: ast.expr, val: Val, value_node: ast.expr) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = val
        elif isinstance(tgt, ast.Attribute):
            self._store_attr(tgt, val, value_node)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if (isinstance(value_node, (ast.Tuple, ast.List))
                    and len(value_node.elts) == len(tgt.elts)):
                for t, v in zip(tgt.elts, value_node.elts):
                    self._bind(t, self._infer(v), v)
            elif val.elts is not None and len(val.elts) == len(tgt.elts):
                for t, v in zip(tgt.elts, val.elts):
                    self._bind(t, v, value_node)
            else:
                for t in tgt.elts:
                    self._bind(t, ANY, value_node)
        # Subscript / Starred targets: not tracked

    def _store_attr(self, tgt: ast.Attribute, val: Val,
                    where: ast.AST) -> None:
        base = self._infer(tgt.value)
        if base.cls is None or base.cls not in self.tables.classes:
            return
        ann = self.tables.classes[base.cls].fields.get(tgt.attr)
        if ann is None:
            return
        if (ann.unit is not None and not ann.unit.dimensionless
                and _known(val) and val.unit != ann.unit):
            self._mismatch(
                FIELD_MISMATCH, where,
                f"store to {base.cls}.{tgt.attr} "
                f"(declared {ann.unit.symbol})",
                ann.unit, val.unit,  # type: ignore[arg-type]
                hint=f"convert the value to {ann.unit.symbol} or fix "
                     f"the field declaration")

    def _check_return(self, stmt: ast.Return) -> None:
        if stmt.value is None:
            return
        val = self._infer(stmt.value)
        ret = self.ret
        if ret.elts is not None and isinstance(stmt.value, ast.Tuple) \
                and len(stmt.value.elts) == len(ret.elts):
            for expr, ann in zip(stmt.value.elts, ret.elts):
                v = self._infer(expr)
                if (ann.unit is not None and not ann.unit.dimensionless
                        and _known(v) and v.unit != ann.unit):
                    self._mismatch(
                        RETURN_MISMATCH, expr,
                        "returned tuple element disagrees with the "
                        "declared return unit",
                        ann.unit, v.unit)  # type: ignore[arg-type]
            return
        if (ret.unit is not None and not ret.unit.dimensionless
                and _known(val) and val.unit != ret.unit):
            self._mismatch(
                RETURN_MISMATCH, stmt,
                "returned value disagrees with the declared return unit",
                ret.unit, val.unit,  # type: ignore[arg-type]
                hint=f"convert the result to {ret.unit.symbol} "
                     f"(e.g. divide a cycle count by a Hertz frequency "
                     f"for Seconds) or fix the -> annotation")

    # ---- expressions -----------------------------------------------------
    def _infer(self, node: ast.expr) -> Val:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or not isinstance(
                    node.value, (int, float)):
                return ANY
            return SCALAR
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.tables.consts:
                return self.tables.consts[node.id]
            return ANY
        if isinstance(node, ast.Attribute):
            return self._infer_attr(node)
        if isinstance(node, ast.BinOp):
            return self._infer_binop(node)
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, (ast.USub, ast.UAdd)):
                return self._infer(node.operand)
            self._infer(node.operand)
            return ANY
        if isinstance(node, ast.Compare):
            left = self._infer(node.left)
            for op, comp in zip(node.ops, node.comparators):
                right = self._infer(comp)
                if isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                                   ast.Eq, ast.NotEq)):
                    if (_known(left) and _known(right)
                            and left.unit != right.unit):
                        self._mismatch(
                            COMPARE_MISMATCH, node,
                            "comparison across dimensions",
                            left.unit, right.unit)  # type: ignore[arg-type]
                left = right
            return SCALAR
        if isinstance(node, ast.BoolOp):
            vals = [self._infer(v) for v in node.values]
            return self._silent_unify(vals)
        if isinstance(node, ast.IfExp):
            self._infer(node.test)
            return self._silent_unify(
                [self._infer(node.body), self._infer(node.orelse)])
        if isinstance(node, ast.Call):
            return self._infer_call(node)
        if isinstance(node, ast.Tuple):
            return Val(elts=tuple(self._infer(e) for e in node.elts))
        if isinstance(node, ast.Subscript):
            base = self._infer(node.value)
            self._infer_slice(node.slice)
            return Val(unit=base.unit)
        if isinstance(node, (ast.List, ast.Set)):
            for e in node.elts:
                self._infer(e)
            return ANY
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self._infer(k)
            for v in node.values:
                self._infer(v)
            return ANY
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return ANY
        if isinstance(node, ast.Starred):
            self._infer(node.value)
            return ANY
        if isinstance(node, ast.JoinedStr):
            return ANY
        return ANY

    def _infer_slice(self, node: ast.expr) -> None:
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self._infer(part)
        else:
            self._infer(node)

    def _infer_attr(self, node: ast.Attribute) -> Val:
        base = self._infer(node.value)
        if base.cls is not None and base.cls in self.tables.classes:
            ci = self.tables.classes[base.cls]
            ann = ci.fields.get(node.attr)
            if ann is not None:
                return Val(ann.unit, ann.cls)
            return ANY
        # module-qualified constant (hw.MB) or duck field lookup: every
        # class declaring this field name agrees on its unit
        if node.attr in self.tables.consts:
            return self.tables.consts[node.attr]
        duck = self.tables.duck.get(node.attr)
        if duck is not None:
            return Val(duck.unit, duck.cls)
        return ANY

    def _infer_binop(self, node: ast.BinOp) -> Val:
        left = self._infer(node.left)
        right = self._infer(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            return self._add(left, right, node)
        if isinstance(node.op, ast.Mult):
            return self._mul(left, right)
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            return self._div(left, right)
        if isinstance(node.op, ast.Mod):
            return Val(unit=left.unit)
        if isinstance(node.op, ast.Pow):
            if (left.unit is not None
                    and isinstance(node.right, ast.Constant)
                    and isinstance(node.right.value, int)):
                return Val(unit=left.unit ** node.right.value)
            return ANY
        return ANY

    def _add(self, left: Val, right: Val, node: ast.AST) -> Val:
        if left.unit is None:
            return Val(unit=right.unit)
        if right.unit is None:
            return Val(unit=left.unit)
        if left.unit == right.unit:
            return Val(unit=left.unit)
        if left.unit.dimensionless:
            return Val(unit=right.unit)
        if right.unit.dimensionless:
            return Val(unit=left.unit)
        self._mismatch(ADD_MISMATCH, node, "cannot add/subtract",
                       left.unit, right.unit,
                       hint="convert one operand (divide bytes by a "
                            "bandwidth, cycles by a frequency, ...) so "
                            "both sides share a dimension")
        return ANY

    def _mul(self, left: Val, right: Val) -> Val:
        if left.unit is None or right.unit is None:
            return ANY
        return Val(unit=left.unit * right.unit)

    def _div(self, left: Val, right: Val) -> Val:
        if left.unit is None or right.unit is None:
            return ANY
        return Val(unit=left.unit / right.unit)

    def _silent_unify(self, vals: Sequence[Val]) -> Val:
        known = [v for v in vals if _known(v)]
        if known and all(v.unit == known[0].unit for v in known):
            return Val(unit=known[0].unit)
        if known:
            return ANY
        if any(v.unit is not None for v in vals):
            return SCALAR
        return ANY

    def _unify_checked(self, vals: Sequence[Val], node: ast.AST) -> Val:
        known = [v for v in vals if _known(v)]
        for v in known[1:]:
            if v.unit != known[0].unit:
                self._mismatch(ADD_MISMATCH, node,
                               "max/min across dimensions",
                               known[0].unit, v.unit)  # type: ignore[arg-type]
                return ANY
        if known:
            return Val(unit=known[0].unit)
        if any(v.unit is not None for v in vals):
            return SCALAR
        return ANY

    # ---- calls -----------------------------------------------------------
    def _infer_call(self, node: ast.Call) -> Val:
        func = node.func
        name = (func.id if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute)
                else "")

        args = [self._infer(a) for a in node.args]
        kwargs = {kw.arg: self._infer(kw.value)
                  for kw in node.keywords if kw.arg is not None}
        for kw in node.keywords:
            if kw.arg is None:
                self._infer(kw.value)

        if name in _UNIFYING:
            if len(node.args) >= 2 and not any(
                    isinstance(a, ast.Starred) for a in node.args):
                return self._unify_checked(args, node)
            return ANY
        if name in _PASSTHROUGH and len(args) >= 1:
            return Val(unit=args[0].unit)
        if name == "len":
            return SCALAR
        if name == "where" and len(args) == 3:
            return self._silent_unify(args[1:])
        if name == "replace" and node.args:
            # dataclasses.replace(obj, field=value)
            base = args[0]
            if base.cls is not None:
                self._check_ctor_kwargs(base.cls, node)
                return Val(cls=base.cls)
            return ANY

        # constructor?
        cls = None
        if isinstance(func, ast.Name) and func.id in self.tables.classes:
            cls = func.id
        elif isinstance(func, ast.Attribute) \
                and func.attr in self.tables.classes:
            cls = func.attr
        if cls is not None:
            self._check_ctor(cls, node, args)
            return Val(cls=cls)

        # known function (module-level, bare or attribute-qualified) or a
        # method on a known class
        info = None
        if isinstance(func, ast.Attribute):
            base = self._infer(func.value)
            if base.cls is not None and base.cls in self.tables.classes:
                info = self.tables.classes[base.cls].methods.get(func.attr)
            elif name in self.tables.funcs:
                info = self.tables.funcs[name]
        elif name in self.tables.funcs:
            info = self.tables.funcs[name]
        if info is not None:
            self._check_args(info, node, args, kwargs)
            return Val(info.ret.unit, info.ret.cls)
        return ANY

    def _check_args(self, info: FuncInfo, node: ast.Call,
                    args: Sequence[Val], kwargs: Dict[str, Val]) -> None:
        params = info.params[1:] if info.is_method else info.params
        by_name = dict(params)
        by_name.update(info.kwonly)
        for (pname, ann), val, anode in zip(params, args, node.args):
            self._check_one_arg(info.name, pname, ann, val, anode)
        for kname, val in kwargs.items():
            ann = by_name.get(kname)
            if ann is not None:
                self._check_one_arg(info.name, kname, ann, val, node)

    def _check_one_arg(self, fname: str, pname: str, ann: Ann, val: Val,
                       node: ast.AST) -> None:
        if (ann.unit is not None and not ann.unit.dimensionless
                and _known(val) and val.unit != ann.unit):
            self._mismatch(
                CALL_MISMATCH, node,
                f"argument {pname!r} of {fname}() "
                f"(declared {ann.unit.symbol})",
                ann.unit, val.unit,  # type: ignore[arg-type]
                hint=f"pass a {ann.unit.symbol} value or change the "
                     f"parameter annotation")

    def _check_ctor(self, cls: str, node: ast.Call,
                    args: Sequence[Val]) -> None:
        ci = self.tables.classes[cls]
        init = ci.methods.get("__init__")
        if init is not None:
            kwargs = {kw.arg: self._infer(kw.value)
                      for kw in node.keywords if kw.arg is not None}
            self._check_args(init, node, args, kwargs)
            return
        # dataclass-style: positional args follow field declaration order
        for fname, val, anode in zip(ci.order, args, node.args):
            ann = ci.fields.get(fname, ANN_ANY)
            self._check_field(cls, fname, ann, val, anode)
        self._check_ctor_kwargs(cls, node)

    def _check_ctor_kwargs(self, cls: str, node: ast.Call) -> None:
        ci = self.tables.classes[cls]
        for kw in node.keywords:
            if kw.arg is None:
                continue
            ann = ci.fields.get(kw.arg)
            if ann is None:
                continue
            self._check_field(cls, kw.arg, ann, self._infer(kw.value),
                              kw.value)

    def _check_field(self, cls: str, fname: str, ann: Ann, val: Val,
                     node: ast.AST) -> None:
        if (ann.unit is not None and not ann.unit.dimensionless
                and _known(val) and val.unit != ann.unit):
            self._mismatch(
                FIELD_MISMATCH, node,
                f"field {cls}.{fname} (declared {ann.unit.symbol})",
                ann.unit, val.unit,  # type: ignore[arg-type]
                hint=f"convert the value to {ann.unit.symbol} or fix "
                     f"the field declaration")


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def check_sources(named_sources: Dict[str, str]) -> List[Diagnostic]:
    """Run the full two-pass analysis over {filename: source}."""
    modules: Dict[str, ast.Module] = {}
    diags: List[Diagnostic] = []
    for fname, src in named_sources.items():
        try:
            modules[fname] = ast.parse(src, filename=fname)
        except SyntaxError as exc:
            diags.append(Diagnostic(
                rule="unit.parse-error", severity="error",
                message=str(exc), location=f"{fname}:{exc.lineno or 0}"))
    tables = _build_tables(modules)
    for fname, mod in modules.items():
        checker = _Checker(tables, fname, diags)
        checker.check_module_body(mod)
        for node in mod.body:
            if isinstance(node, ast.FunctionDef):
                checker.check_function(node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        checker.check_function(item, cls=node.name)
    diags.sort(key=lambda d: (d.location, d.rule))
    return diags


def check_source(src: str, filename: str = "<snippet>") -> List[Diagnostic]:
    """Analyse a standalone snippet (the mutant suite's entry point)."""
    return check_sources({filename: src})


def _expand(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        else:
            out.append(path)
    return out


def check_paths(paths: Iterable[str]) -> List[Diagnostic]:
    """Analyse files / directories together (one merged symbol table)."""
    sources: Dict[str, str] = {}
    for path in _expand(paths):
        sources[str(path)] = path.read_text()
    return check_sources(sources)


# ---------------------------------------------------------------------------
# registry self-check: one minimal mutant per rule, proving each fires
# ---------------------------------------------------------------------------

_SAMPLE_MUTANTS: Dict[str, str] = {
    ADD_MISMATCH: (
        "from repro_torch.core.units import Bytes, Seconds\n"
        "def f(n: Bytes, t: Seconds) -> float:\n"
        "    return n + t\n"),
    COMPARE_MISMATCH: (
        "from repro_torch.core.units import Bytes, Seconds\n"
        "def f(n: Bytes, t: Seconds) -> bool:\n"
        "    return n < t\n"),
    ASSIGN_MISMATCH: (
        "from repro_torch.core.units import Bytes, Seconds\n"
        "def f(n: Bytes) -> None:\n"
        "    t: Seconds = n\n"),
    FIELD_MISMATCH: (
        "from dataclasses import dataclass\n"
        "from repro_torch.core.units import Bytes, Elements\n"
        "@dataclass\n"
        "class Spec:\n"
        "    n_bytes: Bytes\n"
        "def f(n: Elements) -> Spec:\n"
        "    return Spec(n_bytes=n)\n"),
    RETURN_MISMATCH: (
        "from repro_torch.core.units import Cycles, Seconds\n"
        "def f(c: Cycles) -> Seconds:\n"
        "    return c\n"),
    CALL_MISMATCH: (
        "from repro_torch.core.units import Bytes, Seconds\n"
        "def g(t: Seconds) -> Seconds:\n"
        "    return t\n"
        "def f(n: Bytes) -> Seconds:\n"
        "    return g(n)\n"),
}


def registry_diagnostics() -> Dict[str, List[Diagnostic]]:
    """Per-rule diagnostics from each rule's built-in sample mutant."""
    return {rule_id: [d for d in check_source(src) if d.rule == rule_id]
            for rule_id, src in _SAMPLE_MUTANTS.items()}


def registry_selfcheck() -> None:
    """Raise unless every registered rule fires on its sample mutant."""
    missing_sample = set(RULES) - set(_SAMPLE_MUTANTS)
    if missing_sample:
        raise AssertionError(
            f"rules without a sample mutant: {sorted(missing_sample)}")
    for rule_id, diags in registry_diagnostics().items():
        if not diags:
            raise AssertionError(
                f"rule {rule_id} did not fire on its sample mutant")
