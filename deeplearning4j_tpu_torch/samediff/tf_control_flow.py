"""TF control-flow import: While/If and the legacy V1 dataflow ops (port of
``deeplearning4j_tpu/samediff/tf_control_flow.py``).

Both TF encodings land on the SameDiff structured ``while_loop``/``cond``
nodes (samediff.py). The V1 rewrite builds its functions and nodes with the
port's plain GraphDef classes (``tf_graphdef.py``), not TF's ``*_pb2``.

Two encodings are handled:

* **Functional** (TF2 / frozen ``tf.function``): ``While``/``StatelessWhile``
  and ``If``/``StatelessIf`` nodes whose ``cond``/``body``/branch attrs name
  FunctionDefs in the GraphDef library. Each FunctionDef is imported into a
  sub-SameDiff through the same TF_OP_RULES registry.
* **V1 dataflow** (``tf.compat.v1.while_loop`` / ``tf.compat.v1.cond``):
  - while: ``Enter -> Merge -> [LoopCond gate] -> Switch -> body ->
    NextIteration`` frames are reconstructed into a structured loop: Merges
    are the carry, the LoopCond input subexpression becomes the cond
    subgraph, Switch:1 ... NextIteration becomes the body subgraph, Exits
    are the loop outputs. Loop-invariant Enters are appended to the carry.
  - cond (no frame): Switch/Merge without LoopCond. Both branches are
    imported (they are side-effect free tensors) and Merge selects with
    ``where(pred, true_val, false_val)``, a select in place of
    the reference's dead/alive branch propagation.

Nested V1 frames (loop-in-loop) are rejected with a clear error; the
functional encoding nests fine (sub-SameDiffs recurse).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .tf_graphdef import ArgDef, AttrValue, FunctionDef, GraphDef, NameAttrList, NodeDef, OpDef


def _fn_ref(ref: str) -> str:
    """FunctionDef node_def input refs are ``node:out_name:idx`` or
    ``node:out_name`` (idx 0) or a bare arg name; GraphDef refs are
    ``node:idx``. Canonicalize to ``node`` / ``node:idx``."""
    parts = ref.split(":")
    if len(parts) == 1:
        return ref
    if len(parts) == 3:
        return parts[0] if parts[2] == "0" else f"{parts[0]}:{parts[2]}"
    # two parts: numeric suffix = graphdef index form, else function out name
    return ref if parts[1].isdigit() else parts[0]


def import_tf_function(importer, fname: str):
    """Import GraphDef-library FunctionDef ``fname`` into a sub-SameDiff.
    Returns (sub_sd, output_names); placeholders are ``arg0..argN`` in
    signature order (the structured-node calling convention)."""
    lib = {f.signature.name: f for f in importer.graph_def.library.function}
    if fname not in lib:
        raise ValueError(f"GraphDef library has no function {fname!r}")
    fdef = lib[fname]

    sub = importer.__class__(importer.sd.device)
    sub.graph_def = importer.graph_def  # nested functions resolve here
    for i, arg in enumerate(fdef.signature.input_arg):
        ph = sub.sd.placeholder(f"arg{i}")
        sub._produced[arg.name] = ph

    # FunctionDef.node_def carries no ordering guarantee — topo-sort first
    from .tf_import import _iterative_topo

    by_name = {n.name: n for n in fdef.node_def}
    deps = {
        n.name: [_fn_ref(i.lstrip("^")).split(":")[0] for i in n.input]
        for n in fdef.node_def
    }
    order = _iterative_topo(
        [n.name for n in fdef.node_def], deps,
        cycle_msg=f"function {fname!r}: cyclic node {{!r}}")

    for name in order:
        node = by_name[name]
        rewritten = node.copy(input=[
            ("^" + _fn_ref(i[1:])) if i.startswith("^") else _fn_ref(i)
            for i in node.input])
        sub._import_node(rewritten)

    out_names = []
    for arg in fdef.signature.output_arg:
        ref = _fn_ref(fdef.ret[arg.name])
        var = sub.resolve(ref)
        out_names.append(var.name)
    return sub.sd, out_names


def register_functional_rules(tf_rule, TF_OP_RULES):
    """Install While/StatelessWhile and If/StatelessIf rules."""

    @tf_rule("While", "StatelessWhile")
    def _while(ctx):
        imp = ctx.importer
        cond_sd, cond_outs = import_tf_function(imp, ctx.attr["cond"].func.name)
        body_sd, body_outs = import_tf_function(imp, ctx.attr["body"].func.name)
        n = len(ctx.inputs)
        node_var = imp.sd._op(
            "while_loop", *(ctx.var(i) for i in range(n)), name=ctx.name,
            cond_graph=cond_sd, cond_outputs=cond_outs,
            body_graph=body_sd, body_outputs=body_outs, n_vars=n,
        )
        node_var.node.n_outputs = n
        outs = {i: imp.sd._op("getitem", node_var, item=i) for i in range(n)}
        imp._multi_outputs[ctx.name] = outs
        return outs[0]

    @tf_rule("If", "StatelessIf")
    def _if(ctx):
        imp = ctx.importer
        t_sd, t_outs = import_tf_function(imp, ctx.attr["then_branch"].func.name)
        f_sd, f_outs = import_tf_function(imp, ctx.attr["else_branch"].func.name)
        node_var = imp.sd._op(
            "cond", *(ctx.var(i) for i in range(len(ctx.inputs))), name=ctx.name,
            true_graph=t_sd, true_outputs=t_outs,
            false_graph=f_sd, false_outputs=f_outs, n_vars=len(ctx.inputs) - 1,
        )
        node_var.node.n_outputs = len(t_outs)
        outs = {i: imp.sd._op("getitem", node_var, item=i)
                for i in range(len(t_outs))}
        imp._multi_outputs[ctx.name] = outs
        return outs[0]


# ---------------------------------------------------------------------------
# V1 dataflow reconstruction
# ---------------------------------------------------------------------------

_V1_OPS = ("Enter", "Merge", "Switch", "Exit", "NextIteration", "LoopCond",
           "RefEnter", "RefMerge", "RefSwitch", "RefExit", "RefNextIteration")


def has_v1_control_flow(gd) -> bool:
    return any(n.op in _V1_OPS for n in gd.node)


class _Frame:
    def __init__(self, name: str):
        self.name = name
        self.enters: List = []       # Enter nodes
        self.merges: List = []       # Merge nodes (loop carry)
        self.loop_cond = None        # LoopCond node
        self.switches: Dict[str, object] = {}  # merge name -> Switch node
        self.exits: Dict[str, object] = {}     # switch name -> Exit node
        self.next_iters: Dict[str, object] = {}  # merge name -> NextIteration


def rewrite_v1_loops(gd):
    """Rewrite every V1 while frame in ``gd`` into a functional
    ``StatelessWhile`` node + library functions, so the main import path
    only ever sees functional control flow. Returns a NEW GraphDef.

    The reconstruction (canonical tf.compat.v1.while_loop layout):
      Enter(init_i) -> Merge_i <- NextIteration_i
      pred = subexpr(Merge_*) -> LoopCond
      Switch_i(Merge_i, LoopCond): :0 -> Exit_i (loop output),
                                   :1 -> body -> NextIteration_i
    Loop-invariant ``Enter``s (no Merge consumer) become extra carry slots
    returned unchanged by the body.
    """
    by_name = {n.name: n for n in gd.node}
    consumers: Dict[str, List] = {}
    for n in gd.node:
        for i in n.input:
            src = i.lstrip("^").split(":")[0]
            consumers.setdefault(src, []).append(n)

    frames: Dict[str, _Frame] = {}
    for n in gd.node:
        if n.op in ("Enter", "RefEnter"):
            fname = n.attr["frame_name"].s.decode()
            frames.setdefault(fname, _Frame(fname)).enters.append(n)

    if not frames:
        return gd
    # frame nesting check: an Enter whose input chain passes through another
    # frame's non-Exit member means nesting
    for f in frames.values():
        for e in f.enters:
            src = by_name.get(e.input[0].split(":")[0])
            if src is not None and src.op in ("Enter", "Merge", "Switch",
                                              "NextIteration"):
                raise NotImplementedError(
                    "nested V1 while frames are not supported; re-export with "
                    "tf.function (functional While) instead")

    out = GraphDef(versions=gd.versions)
    out.library.function.extend(gd.library.function)

    removed: set = set()
    replacements: Dict[str, str] = {}  # old ref -> new ref
    new_nodes: List = []
    fn_counter = [0]

    for fname, fr in frames.items():
        # ---- gather structure ------------------------------------------
        for e in fr.enters:
            for c in consumers.get(e.name, []):
                if c.op in ("Merge", "RefMerge"):
                    if c not in fr.merges:
                        fr.merges.append(c)
        loop_conds = [n for n in gd.node if n.op == "LoopCond" and any(
            m.name in _ancestors(n, by_name, stop_ops=("Enter", "Merge"))
            for m in fr.merges)]
        if not fr.merges or not loop_conds:
            raise NotImplementedError(
                f"V1 frame {fname!r}: unrecognized loop structure "
                "(no Merge/LoopCond)")
        fr.loop_cond = loop_conds[0]
        for m in fr.merges:
            sw = [c for c in consumers.get(m.name, []) if c.op in ("Switch", "RefSwitch")]
            if len(sw) != 1:
                raise NotImplementedError(
                    f"V1 frame {fname!r}: loop var {m.name} has {len(sw)} "
                    "Switches (expected 1)")
            fr.switches[m.name] = sw[0]
            for c in consumers.get(sw[0].name, []):
                if c.op in ("Exit", "RefExit"):
                    fr.exits[m.name] = c
        # NextIteration per merge: merge.input[1]
        for m in fr.merges:
            ni_name = m.input[1].split(":")[0]
            ni = by_name.get(ni_name)
            if ni is None or ni.op not in ("NextIteration", "RefNextIteration"):
                raise NotImplementedError(
                    f"V1 frame {fname!r}: Merge {m.name} second input is not "
                    "NextIteration")
            fr.next_iters[m.name] = ni

        n_vars = len(fr.merges)
        # loop-invariant enters (referenced by body, not via a Merge)
        invariant = [e for e in fr.enters
                     if not any(m.input[0].split(":")[0] == e.name for m in fr.merges)]

        # ---- member sets ------------------------------------------------
        cond_members = _between(
            {m.name for m in fr.merges} | {e.name for e in invariant},
            {fr.loop_cond.input[0].split(":")[0]}, by_name)
        body_targets = {fr.next_iters[m.name].input[0].split(":")[0]
                        for m in fr.merges}
        body_members = _between(
            {fr.switches[m.name].name for m in fr.merges} | {e.name for e in invariant},
            body_targets, by_name)

        # ---- build FunctionDefs ----------------------------------------
        carry_refs = [f"arg_lv{i}" for i in range(n_vars)] + \
                     [f"arg_inv{j}" for j in range(len(invariant))]
        # boundary: inside cond, Merge_i reads arg i; inside body, Switch_i:1
        # reads arg i; invariant Enter j reads arg n_vars+j
        cond_bound = {m.name: carry_refs[i] for i, m in enumerate(fr.merges)}
        body_bound = {fr.switches[m.name].name: carry_refs[i]
                      for i, m in enumerate(fr.merges)}
        for j, e in enumerate(invariant):
            cond_bound[e.name] = carry_refs[n_vars + j]
            body_bound[e.name] = carry_refs[n_vars + j]

        idx = fn_counter[0]
        fn_counter[0] += 1
        cond_fn_name = f"__v1_loop_cond_{idx}"
        body_fn_name = f"__v1_loop_body_{idx}"

        cond_ret = [fr.loop_cond.input[0]]
        _make_function(
            out.library, cond_fn_name, carry_refs, cond_members, cond_bound,
            cond_ret, by_name, n_outputs=1)
        body_ret = [fr.next_iters[m.name].input[0] for m in fr.merges] + \
                   [carry_refs[n_vars + j] for j in range(len(invariant))]
        _make_function(
            out.library, body_fn_name, carry_refs, body_members, body_bound,
            body_ret, by_name, n_outputs=n_vars + len(invariant))

        # ---- the functional While node ---------------------------------
        wnode = NodeDef(name=f"__v1_while_{idx}", op="StatelessWhile")
        for m in fr.merges:
            wnode.input.append(by_name[m.input[0].split(":")[0]].input[0])
        for e in invariant:
            wnode.input.append(e.input[0])
        wnode.attr["cond"] = _func_attr(cond_fn_name)
        wnode.attr["body"] = _func_attr(body_fn_name)
        # splice the While where the frame's LAST Enter sat: all its inputs
        # (the Enter inits) are already imported by then, and every Exit
        # consumer comes later — preserving the GraphDef's topological order
        frame_node_names = {e.name for e in fr.enters}
        last = [n.name for n in gd.node if n.name in frame_node_names][-1]
        new_nodes.append((last, wnode))

        # Exit_i -> while:i
        for i, m in enumerate(fr.merges):
            ex = fr.exits.get(m.name)
            if ex is not None:
                replacements[ex.name] = f"{wnode.name}:{i}" if i else wnode.name

        removed |= {n for n in cond_members} | {n for n in body_members}
        removed |= {e.name for e in fr.enters}
        removed |= {m.name for m in fr.merges}
        removed |= {fr.loop_cond.name}
        removed |= {s.name for s in fr.switches.values()}
        removed |= {x.name for x in fr.exits.values()}
        removed |= {ni.name for ni in fr.next_iters.values()}

    # a member (e.g. a Const shared by the loop body and outer graph) may be
    # consumed outside the frame: keep such nodes in the outer graph too
    changed = True
    while changed:
        changed = False
        for n in gd.node:
            if n.name in removed and n.name not in replacements:
                continue  # only surviving nodes pin dependencies
            survivors = [n] if n.name not in removed else []
            for s in survivors:
                for i in s.input:
                    base = i.lstrip("^").split(":")[0]
                    if base in removed and base not in replacements and \
                            base in by_name and by_name[base].op not in _V1_OPS:
                        removed.discard(base)
                        changed = True

    splice_at = {}
    for anchor, wnode in new_nodes:
        splice_at.setdefault(anchor, []).append(wnode)
    for n in gd.node:
        for wnode in splice_at.get(n.name, ()):  # anchors are removed nodes
            out.node.append(wnode)
        if n.name in removed:
            continue
        inputs = []
        for i in n.input:
            ctrl = i.startswith("^")
            base = i.lstrip("^").split(":")[0]
            if base in replacements:
                i = replacements[base] if not ctrl else "^" + replacements[base].split(":")[0]
            inputs.append(i)
        out.node.append(n.copy(input=inputs))
    return out


def _func_attr(name: str) -> AttrValue:
    return AttrValue(func=NameAttrList(name=name))


def _ancestors(node, by_name, stop_ops=()):
    seen = set()
    stack = [i.lstrip("^").split(":")[0] for i in node.input]
    while stack:
        name = stack.pop()
        if name in seen or name not in by_name:
            continue
        seen.add(name)
        n = by_name[name]
        if n.op in stop_ops:
            continue
        stack.extend(i.lstrip("^").split(":")[0] for i in n.input)
    return seen


def _between(sources: set, targets: set, by_name) -> set:
    """Node names on paths from (exclusive) sources to (inclusive) targets."""
    members = set()
    stack = list(targets)
    while stack:
        name = stack.pop()
        if name in members or name in sources or name not in by_name:
            continue
        members.add(name)
        stack.extend(i.lstrip("^").split(":")[0] for i in by_name[name].input)
    return members


def _make_function(library, fn_name: str, arg_names: Sequence[str],
                   members: set, boundary: Dict[str, str],
                   ret_refs: Sequence[str], by_name, n_outputs: int) -> None:
    """Emit a FunctionDef with inputs ``arg_names``, body = copies of
    ``members`` with boundary refs rewritten to args, outputs = ret_refs."""
    fdef = FunctionDef(signature=OpDef(name=fn_name))
    for a in arg_names:
        # the type is informational; import is dtype-agnostic
        fdef.signature.input_arg.append(ArgDef(name=a, type=1))

    def rewrite_ref(ref: str) -> str:
        ctrl = ref.startswith("^")
        body = ref.lstrip("^")
        base, _, idx = body.partition(":")
        if base in boundary:
            # Switch:1 / Merge:0 / Enter outputs all alias the carry arg
            new = boundary[base]
        else:
            new = base if not idx or idx == "0" else f"{base}:output:{idx}"
        if ctrl:
            return "^" + new.split(":")[0]
        return new

    for name in sorted(members):
        n = by_name[name]
        fdef.node_def.append(n.copy(input=[rewrite_ref(i) for i in n.input]))

    for k in range(n_outputs):
        fdef.signature.output_arg.append(ArgDef(name=f"out{k}", type=1))
        ref = ret_refs[k]
        base, _, idx = ref.partition(":")
        if base in boundary:
            fdef.ret[f"out{k}"] = boundary[base]
        elif ref.startswith("arg_"):
            fdef.ret[f"out{k}"] = ref
        else:
            fdef.ret[f"out{k}"] = f"{base}:output:{idx or '0'}"
    library.function.append(fdef)


def register_v1_cond_rules(tf_rule, TF_OP_RULES):
    """Frameless Switch/Merge (tf.compat.v1.cond): both branches are
    imported; Merge selects with where(pred, t, f)."""

    @tf_rule("Switch", "RefSwitch")
    def _switch(ctx):
        imp = ctx.importer
        data, pred = ctx.var(0), ctx.var(1)
        # both outputs carry the data; branch identity lives in _branch_of
        outs = {0: data, 1: data}
        imp._multi_outputs[ctx.name] = outs
        imp._branch_of[ctx.name] = pred
        return data

    @tf_rule("Merge", "RefMerge")
    def _merge(ctx):
        imp = ctx.importer
        pred = None
        sides: Dict[bool, object] = {}
        for i, ref in enumerate(ctx.inputs):
            info = imp.trace_branch(ref)
            if info is None:
                continue
            p, side = info
            pred = p
            sides[side] = ctx.var(i)
        if pred is None or len(sides) != 2:
            raise NotImplementedError(
                f"Merge {ctx.name!r}: could not associate inputs with a "
                "Switch predicate (only frameless tf.cond graphs supported)")
        out = imp.sd._op("select", pred, sides[True], sides[False], name=ctx.name)
        imp._multi_outputs[ctx.name] = {0: out}
        return out
