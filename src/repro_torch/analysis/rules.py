"""The repo-specific invariant rules (everything except lock discipline).

Each rule codifies a contract a previous PR proved dynamically and this PR
enforces statically — the rule docstrings name the contract and the PR that
established it.  Scopes are dotted-module prefixes: the linter derives the
module name from the file path, so fixtures can inject any module identity
via ``lint_source(..., module=...)``.

This is the port's copy of ``repro/analysis/rules.py``: every rule keeps its
name, logic and message, and every scope names the port's counterpart
modules (``repro_torch.*``).  ``no-eager-jax`` keeps guarding the port
against jax; ``no-eager-torch`` is its counterpart for torch, which the port
imports inside the functions that run on a device, as the reference does
with jax.
"""

from __future__ import annotations

import ast
import sys
from typing import Iterable, Iterator

from repro_torch.analysis.engine import (
    FileContext,
    Finding,
    Rule,
    ancestors,
    call_name,
    dotted_name,
    in_function,
    in_type_checking,
    register,
)

#: modules that must stay importable without pulling jax into the process
#: (the predict / serving / observability path — PR 3 and PR 7's contract)
JAX_FREE_SCOPE = (
    "repro_torch.api",
    "repro_torch.serving",
    "repro_torch.obs",
    "repro_torch.core",
    "repro_torch.runtime",
    "repro_torch.accelerators",
    "repro_torch.checkpoint",
    "repro_torch.registry",
    "repro_torch.analysis",
    "repro_torch.launch.serve",
)

#: modules known to import jax at module scope (importing them eagerly from a
#: jax-free module is a transitive violation, the failure mode the old
#: subprocess test could only catch one import-graph snapshot at a time)
_JAX_HEAVY_PREFIXES = (
    "jax",
    "jaxlib",
    "flax",
    "optax",
    "repro_torch.kernels",
    "repro_torch.optim",
    "repro_torch.train",
    "repro_torch.distributed",
    "repro_torch.launch.mesh",
    "repro_torch.launch.train",
)
def _is_jax_heavy(modname: str) -> bool:
    # repro_torch.models.* is jax-heavy EXCEPT the plain-dataclass config module
    # (and the package __init__, which only re-exports it).  Anything *under*
    # the config module (``from repro_torch.models.config import InputShape``
    # yields the candidate ``repro_torch.models.config.InputShape``) is safe too.
    if modname == "repro_torch.models" or modname == "repro_torch.models.config":
        return False
    if modname.startswith("repro_torch.models.config."):
        return False
    if modname.startswith("repro_torch.models."):
        return True
    return any(
        modname == p or modname.startswith(p + ".") for p in _JAX_HEAVY_PREFIXES
    )


def _module_scope_imports(ctx: FileContext) -> Iterator[tuple[ast.AST, str]]:
    """(node, imported-module-name) pairs executed at import time."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            if in_function(node) or in_type_checking(node):
                continue
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom):
            if in_function(node) or in_type_checking(node) or node.level:
                continue
            base = node.module or ""
            yield node, base
            for alias in node.names:
                # ``from repro_torch.models import transformer`` imports the
                # submodule; ``from repro_torch.models import ModelConfig`` makes
                # the same candidate name, which simply matches no prefix.
                yield node, f"{base}.{alias.name}"


@register
class NoEagerJax(Rule):
    """PR 3/7: the predict/serving/obs path must never import jax eagerly.

    Workers, servers and report CLIs start in milliseconds on jax-free boxes
    because ``jax`` (and the model stack built on it) is imported inside the
    functions that need it.  Until now one subprocess test pinned this for
    one snapshot of the import graph; this rule pins every module-scope
    import statement on the protected path, including *transitive* eagerness
    through known jax-heavy repro modules.
    """

    name = "no-eager-jax"
    description = (
        "predict/serving/obs-path modules must not import jax (or jax-heavy "
        "repro modules) at module scope"
    )
    scope = JAX_FREE_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node, modname in _module_scope_imports(ctx):
            if _is_jax_heavy(modname):
                yield ctx.finding(
                    self.name, node,
                    f"module-scope import of jax-heavy module {modname!r}; "
                    "import it inside the function that needs it (this module "
                    "is on the jax-free predict/serving/obs path)",
                )


#: port modules that import torch at module scope (importing one eagerly from
#: a torch-free module is a transitive violation, as for jax above)
_TORCH_HEAVY_PREFIXES = (
    "torch",
    "repro_torch.device",
    "repro_torch.weights",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.ref",
    "repro_torch.train",
    "repro_torch.distributed",
    "repro_torch.launch.mesh",
    "repro_torch.launch.train",
)


def _is_torch_heavy(modname: str) -> bool:
    # repro_torch.models.* imports torch EXCEPT the plain-dataclass config
    # module (and the package __init__), as for jax in the reference.
    if modname == "repro_torch.models" or modname == "repro_torch.models.config":
        return False
    if modname.startswith("repro_torch.models.config."):
        return False
    if modname.startswith("repro_torch.models."):
        return True
    return any(
        modname == p or modname.startswith(p + ".") for p in _TORCH_HEAVY_PREFIXES
    )


@register
class NoEagerTorch(Rule):
    """The port's counterpart of ``no-eager-jax``: torch stays out of imports.

    The estimation, serving and observability path of the port (the same
    modules as the reference's jax-free path) imports torch inside the
    functions that run on a device, so that a pool worker, the oracle
    service or the report CLI starts without loading torch, and a numpy
    backend never pays for it.  Transitive eagerness through the port's
    torch-heavy modules (the model stack, the kernels' wrappers, the device
    helper) is flagged too.
    """

    name = "no-eager-torch"
    description = (
        "the port's predict/serving/obs-path modules must not import torch "
        "(or torch-heavy repro_torch modules) at module scope"
    )
    scope = JAX_FREE_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node, modname in _module_scope_imports(ctx):
            if _is_torch_heavy(modname):
                yield ctx.finding(
                    self.name, node,
                    f"module-scope import of torch-heavy module {modname!r}; "
                    "import it inside the function that needs it (this module "
                    "is on the port's torch-free predict/serving/obs path)",
                )


#: modules that must import with *no third-party dependencies at all*
#: (``repro_torch.obs.report`` runs on trace-collection boxes; ``repro_torch.analysis``
#: must lint a tree on machines with nothing but a Python installed)
STDLIB_ONLY_SCOPE = ("repro_torch.obs", "repro_torch.analysis")


@register
class StdlibOnly(Rule):
    """Observability reporting and this linter must run with bare Python.

    ``repro_torch.obs.report`` digests traces on whatever box collected them;
    ``repro_torch.analysis`` gates CI checkouts before dependencies install.  Both
    therefore import stdlib (plus other stdlib-only repro modules) at module
    scope, and nothing else — numpy included (snapshot-time numpy use lives
    inside functions).  Pinned dynamically by the import-blocker subprocess
    test in tests/test_analysis.py; enforced statically here.
    """

    name = "stdlib-only"
    description = (
        "repro_torch.obs / repro_torch.analysis modules must import only stdlib (and "
        "other stdlib-only repro modules) at module scope"
    )
    scope = STDLIB_ONLY_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        stdlib = sys.stdlib_module_names
        for node, modname in _module_scope_imports(ctx):
            if not modname:
                continue
            top = modname.split(".", 1)[0]
            if top in stdlib:
                continue
            if top == "repro_torch":
                ok = any(
                    modname == p or modname.startswith(p + ".")
                    for p in STDLIB_ONLY_SCOPE
                )
                # ``from repro_torch.obs.trace import span`` style names resolve to
                # non-module attributes too; prefix-match handles both.
                if ok:
                    continue
                yield ctx.finding(
                    self.name, node,
                    f"module-scope import of {modname!r} drags non-stdlib-only "
                    "repro code (and its third-party deps) into a module that "
                    "must import with bare Python",
                )
            else:
                yield ctx.finding(
                    self.name, node,
                    f"module-scope import of third-party module {modname!r} in "
                    "a stdlib-only module; defer it into the function that "
                    "needs it",
                )


# ----------------------------------------------------------------- rng rules
#: Generator draw methods whose call order is part of the estimator format
_DRAW_METHODS = frozenset(
    {
        "integers", "random", "choice", "normal", "uniform",
        "standard_normal", "permutation", "shuffle", "exponential",
        "poisson", "binomial", "beta", "gamma", "bytes",
    }
)
#: numpy.random module attributes that are NOT the legacy global-state API
_NP_RANDOM_OK = frozenset(
    {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
     "MT19937", "SFC64", "BitGenerator"}
)


def _is_rng_name(name: str) -> bool:
    return name == "rng" or name.endswith("rng")


def _test_is_data_dependent(test: ast.AST) -> bool:
    """A predicate referencing any variable counts as data-dependent.

    Deliberately conservative: ``if self.bootstrap:`` is a per-estimator
    constant, but the linter cannot prove that — such draws carry an inline
    suppression naming the locked stream contract instead (the point of the
    rule is that every conditional draw is *argued*, not silent).
    """
    for node in ast.walk(test):
        if isinstance(node, (ast.Name, ast.Attribute, ast.Call)):
            return True
    return False


@register
class RngDiscipline(Rule):
    """PR 2/4: the RNG bitstream is part of the estimator format.

    Training sets, bootstrap draws and per-node feature draws must consume
    the seeded generator at exactly the historical stream positions — PR 4's
    post-mortem documents how a reordered ``rng.choice`` silently re-keys
    every golden test.  Three bug classes are flagged: legacy module-global
    ``np.random.*`` calls (shared mutable state), unseeded ``default_rng()``
    (non-reproducible by construction), and generator draws inside
    conditionals/comprehensions whose predicate depends on data (stream
    position becomes input-dependent).
    """

    name = "rng-discipline"
    description = (
        "no module-global np.random state, no unseeded default_rng(), no "
        "data-dependent conditional rng draws in core/, api/ and fault plans"
    )
    scope = ("repro_torch.core", "repro_torch.api", "repro_torch.runtime.faults")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        aliases = self._draw_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is not None:
                yield from self._check_module_state(ctx, node, name)
                yield from self._check_unseeded(ctx, node, name)
            if self._is_draw(node, aliases):
                cond = self._conditional_context(node)
                if cond is not None:
                    yield ctx.finding(
                        self.name, node,
                        "rng draw inside a data-dependent "
                        f"{cond}: the generator's stream position becomes "
                        "input-dependent (the PR-4 bug class); hoist the draw "
                        "or suppress with the locked-stream justification",
                    )

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _draw_aliases(tree: ast.AST) -> frozenset[str]:
        """Names bound to a draw method (``choice = rng.choice``)."""
        out = set()
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in _DRAW_METHODS
            ):
                base = node.value.value
                if isinstance(base, ast.Name) and _is_rng_name(base.id):
                    out.add(node.targets[0].id)
        return frozenset(out)

    def _check_module_state(self, ctx, node: ast.Call, name: str):
        parts = name.split(".")
        if len(parts) >= 3 and parts[-2] == "random" and parts[0] in ("np", "numpy"):
            fn = parts[-1]
            if fn not in _NP_RANDOM_OK:
                yield ctx.finding(
                    self.name, node,
                    f"call to module-global numpy RNG state ({name}); use an "
                    "explicitly seeded np.random.default_rng(seed) generator "
                    "threaded through the call chain",
                )

    def _check_unseeded(self, ctx, node: ast.Call, name: str):
        if name.split(".")[-1] == "default_rng" and not node.args and not node.keywords:
            yield ctx.finding(
                self.name, node,
                "unseeded default_rng(): campaigns must be replayable from "
                "their seed; pass an explicit seed (or a SeedSequence)",
            )

    @staticmethod
    def _is_draw(node: ast.Call, aliases: frozenset[str]) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _DRAW_METHODS:
            base = func.value
            if isinstance(base, ast.Name) and _is_rng_name(base.id):
                return True
        if isinstance(func, ast.Name) and func.id in aliases:
            return True
        return False

    @staticmethod
    def _conditional_context(node: ast.AST) -> str | None:
        """The nearest enclosing data-dependent conditional, if any."""
        prev = node
        for anc in ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None  # don't escape the defining function
            if isinstance(anc, (ast.If, ast.While)):
                # Being inside the test itself is fine (the draw *is* the
                # predicate input); inside body/orelse is the hazard.
                if prev is not anc.test and _test_is_data_dependent(anc.test):
                    return "'if'" if isinstance(anc, ast.If) else "'while' loop"
            if isinstance(anc, ast.IfExp):
                if prev is not anc.test and _test_is_data_dependent(anc.test):
                    return "conditional expression"
            if isinstance(anc, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                if any(gen.ifs for gen in anc.generators):
                    return "filtered comprehension"
            prev = anc
        return None


# ------------------------------------------------------- float determinism
def _is_unordered(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        name = call_name(expr)
        if name in ("set", "frozenset"):
            return True
    return False


@register
class FloatDeterminism(Rule):
    """PR 2-7: parity-locked numerics must not accumulate in set order.

    The engines are certified *bitwise* against frozen references; float
    addition is not associative, so any accumulation whose operand order
    comes from an unordered collection (or whose rounding differs from the
    plain left fold, like ``math.fsum``) silently breaks every golden test
    the moment hash seeds or interning change.
    """

    name = "float-determinism"
    description = (
        "no accumulation over sets and no math.fsum in parity-locked "
        "modules (core/, accelerators/, api/)"
    )
    scope = ("repro_torch.core", "repro_torch.accelerators", "repro_torch.api")

    _SUM_NAMES = ("sum", "np.sum", "numpy.sum", "math.fsum", "fsum")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name in ("math.fsum", "fsum"):
                    yield ctx.finding(
                        self.name, node,
                        "math.fsum rounds differently from the plain float64 "
                        "left fold the parity references use; accumulate with "
                        "the same fold as the locked reference",
                    )
                elif name in self._SUM_NAMES and node.args:
                    arg = node.args[0]
                    hazard = _is_unordered(arg)
                    if not hazard and isinstance(
                        arg, (ast.GeneratorExp, ast.ListComp)
                    ):
                        hazard = any(
                            _is_unordered(gen.iter) for gen in arg.generators
                        )
                    if hazard:
                        yield ctx.finding(
                            self.name, node,
                            f"{name}() over an unordered set: the operand "
                            "order (and therefore the float rounding) depends "
                            "on hashing; sort first or accumulate over an "
                            "ordered container",
                        )
            elif isinstance(node, ast.For) and _is_unordered(node.iter):
                if any(
                    isinstance(sub, ast.AugAssign)
                    for stmt in node.body
                    for sub in ast.walk(stmt)
                ):
                    yield ctx.finding(
                        self.name, node,
                        "accumulation inside a loop over an unordered set: "
                        "iteration order depends on hashing; sort the "
                        "elements first",
                    )


# ------------------------------------------------------ spawn-spec contract
#: calls allowed inside a spawn_spec return expression (value constructors)
_SPAWN_OK_CALLS = frozenset({"dict", "tuple", "list", "str", "int", "float",
                             "bool", "type"})


def _spawn_expr_violation(expr: ast.AST) -> ast.AST | None:
    """First sub-expression that is not picklable-literal-ish, or None."""
    for node in ast.walk(expr):
        if isinstance(node, (ast.Lambda, ast.GeneratorExp, ast.Yield,
                             ast.YieldFrom, ast.Await, ast.NamedExpr)):
            return node
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is None or name.split(".")[0] not in _SPAWN_OK_CALLS:
                return node
    return None


@register
class SpawnSpecPicklable(Rule):
    """PR 3: pool workers rebuild platforms from ``spawn_spec()`` alone.

    Platform *instances* never cross process boundaries (jitted closures and
    device handles don't pickle); the spawn spec — ``(registry_name,
    ctor_kwargs, module)`` — is the entire recipe.  Two failure modes are
    flagged: a spec that smuggles callables/closures into the tuple, and a
    platform with a parameterised constructor that silently inherits the
    base recipe (which rebuilds with default arguments and a *different
    timing model* in every worker).
    """

    name = "spawn-spec-picklable"
    description = (
        "platform spawn_spec() must return a 3-tuple of literals/plain "
        "values; parameterised platforms must override it"
    )
    scope = ("repro_torch.accelerators", "repro_torch.runtime")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {
                n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
            }
            if not self._is_platform(cls, methods):
                continue
            spec = methods.get("spawn_spec")
            init = methods.get("__init__")
            if spec is None:
                if init is not None and len(init.args.args) > 1:
                    yield ctx.finding(
                        self.name, cls,
                        f"platform class {cls.name!r} has a parameterised "
                        "__init__ but inherits the default spawn_spec(): pool "
                        "workers would rebuild it with default arguments (a "
                        "different timing model); override spawn_spec to "
                        "carry every constructor argument",
                    )
                continue
            yield from self._check_spec_body(ctx, cls, spec)

    @staticmethod
    def _is_platform(cls: ast.ClassDef, methods: dict) -> bool:
        for base in cls.bases:
            name = dotted_name(base) or ""
            if name.split(".")[-1] == "Platform":
                return True
        return "measure" in methods and "layer_types" in methods

    def _check_spec_body(self, ctx, cls, spec: ast.FunctionDef):
        returns = [
            n for n in ast.walk(spec) if isinstance(n, ast.Return) and n.value
        ]
        if not returns:
            yield ctx.finding(
                self.name, spec,
                f"{cls.name}.spawn_spec has no return value; it must return "
                "(registry_name, ctor_kwargs, module)",
            )
            return
        for ret in returns:
            value = ret.value
            if not isinstance(value, ast.Tuple) or len(value.elts) != 3:
                yield ctx.finding(
                    self.name, ret,
                    f"{cls.name}.spawn_spec must return a literal 3-tuple "
                    "(registry_name, ctor_kwargs, module)",
                )
                continue
            bad = _spawn_expr_violation(value)
            if bad is not None:
                label = type(bad).__name__
                if isinstance(bad, ast.Call):
                    label = f"call to {call_name(bad) or '<expr>'}"
                yield ctx.finding(
                    self.name, bad,
                    f"{cls.name}.spawn_spec returns a non-literal component "
                    f"({label}): everything in the spec must pickle and "
                    "rebuild identically in a worker process",
                )


# ------------------------------------------------------------- merge order
@register
class MergeOrder(Rule):
    """PR 3: results merge in first-occurrence order, never completion order.

    The runtime's bitwise-identical-for-any-worker-count guarantee exists
    because chunk results are indexed by their position in the submitted
    batch.  ``as_completed`` / ``FIRST_COMPLETED`` reintroduce scheduling
    order into the merge — the exact nondeterminism PR 3 was built to kill.
    """

    name = "merge-order"
    description = (
        "no as_completed / FIRST_COMPLETED result ordering in the "
        "runtime/api/serving merge paths"
    )
    scope = ("repro_torch.runtime", "repro_torch.api", "repro_torch.serving")

    _BANNED = frozenset({"as_completed", "FIRST_COMPLETED"})

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            name = None
            if isinstance(node, ast.Name) and node.id in self._BANNED:
                name = node.id
            elif isinstance(node, ast.Attribute) and node.attr in self._BANNED:
                name = node.attr
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    if alias.name.split(".")[-1] in self._BANNED:
                        name = alias.name
                        break
            if name is not None:
                yield ctx.finding(
                    self.name, node,
                    f"{name} orders results by completion, not by "
                    "first-occurrence batch position; merge by chunk index so "
                    "campaigns stay bitwise-identical for any worker count",
                )


# --------------------------------------------------------- obs zero overhead
def _is_span_call(node: ast.Call) -> str | None:
    func = node.func
    if isinstance(func, ast.Name) and func.id in ("span", "instant", "phase"):
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in ("span", "instant"):
        base = dotted_name(func.value) or ""
        if base.split(".")[-1] in ("obs", "trace") or base in ("repro_torch.obs",):
            return func.attr
    # the port's phase recorder (repro_torch.phases.phase): a span on the same fast path
    if isinstance(func, ast.Attribute) and func.attr == "phase":
        base = dotted_name(func.value) or ""
        if base.split(".")[-1] == "phases":
            return func.attr
    return None


def _computed_string(expr: ast.AST) -> bool:
    if isinstance(expr, ast.JoinedStr):
        return True
    if isinstance(expr, ast.BinOp):  # "a" + x, "fmt" % x
        return True
    if isinstance(expr, ast.Call):
        name = call_name(expr) or ""
        if name.split(".")[-1] in ("format", "join"):
            return True
    return False


def _tracer_guarded(node: ast.AST) -> bool:
    """Inside an ``if`` that already checked the tracer (or a live span)."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if isinstance(anc, ast.If):
            for sub in ast.walk(anc.test):
                if isinstance(sub, ast.Name) and "tracer" in sub.id:
                    return True
                if isinstance(sub, ast.Call) and (
                    (call_name(sub) or "").split(".")[-1] == "get_tracer"
                ):
                    return True
    return False


@register
class ObsZeroOverhead(Rule):
    """PR 8: a disabled span is one global read — nothing else.

    The tracer rides the measurement and serving hot paths; its zero-
    overhead-when-disabled contract (~290 ns, 0 allocations, pinned in
    BENCH_obs.json) only holds if call sites do no work *before* the
    ``span()`` call returns the null singleton.  Flagged: span/instant names
    built with f-strings/formatting (the string is built even when tracing
    is off) and args-dict literals passed positionally (the dict is
    allocated even when tracing is off).  The sanctioned pattern::

        sp = span("serve.coalesce")
        if sp:
            sp.set(payloads=len(payloads))
        with sp:
            ...
    """

    name = "obs-zero-overhead"
    description = (
        "span()/instant() call sites must not format names or allocate "
        "args dicts on the disabled fast path"
    )
    scope = ("repro_torch.api", "repro_torch.serving", "repro_torch.runtime", "repro_torch.core",
             "repro_torch.accelerators", "repro_torch.launch", "repro_torch.obs.report")
    # the port's own phase call sites are held to it too (no reference counterpart)
    scope = scope + ("repro_torch.train", "repro_torch.kernels", "repro_torch.phases")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _is_span_call(node)
            if kind is None:
                continue
            if node.args and _computed_string(node.args[0]):
                yield ctx.finding(
                    self.name, node,
                    f"{kind}() name is formatted at the call site — the "
                    "string is built even with tracing disabled; precompute "
                    "the label (dict lookup / constant) instead",
                )
            args_exprs = list(node.args[1:2]) + [
                kw.value for kw in node.keywords if kw.arg == "args"
            ]
            for expr in args_exprs:
                if isinstance(expr, (ast.Dict, ast.DictComp, ast.Call)):
                    if _tracer_guarded(node):
                        continue
                    yield ctx.finding(
                        self.name, node,
                        f"{kind}() allocates an args mapping even when "
                        "tracing is disabled; use `sp = span(name)` then "
                        "`if sp: sp.set(...)`, or guard on get_tracer()",
                    )
