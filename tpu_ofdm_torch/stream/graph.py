"""Flowgraph topology: a DAG of Blocks flattened into ONE executable Block
(counterpart of tpu_ofdm/stream/graph.py).

A Flowgraph flattens into a single (state, x) -> (state, y) function that
runs its nodes in topological order; every edge is a tensor passed from one
node's apply to the next.  Flowgraph.build() returns a Block, which can be
added as a node of another Flowgraph (hierarchy).

Port conventions (the JAX module's):
  * a node's output is whatever its Block.apply returns as y; a tuple y is
    a multi-port output addressed as (node, port);
  * a NamedTuple y is a single structured value whose FIELDS are named
    out-ports: ('tx', 'samples') reads y.samples;
  * a node with several in-edges receives a TUPLE of inputs ordered by its
    declared in-port index (a 1-input node receives the bare value);
  * graph inputs are declared with add_input(); the built Block's x is the
    bare value (one input) or a tuple in declaration order;
  * graph outputs via set_outputs(): bare or tuple symmetrical with inputs.

Blocks that change the rate (decimators, channelizers) emit tensors of
other shapes; fan-in shapes are checked by the ops that combine them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from tpu_ofdm_torch.stream.block import Block

Port = tuple[str, "int | str"]  # int = tuple index, str = NamedTuple field


def _as_port(ref, side: str = "src") -> Port:
    """'node' -> ('node', 0); ('node', k) passes through; ('node', 'field')
    names a NamedTuple output field.  Named ports are SOURCE-side only
    (output fields); in-ports are dense integers, so side='dst' rejects a
    non-digit string port up front instead of surfacing later as a
    confusing 'in-ports not dense' error."""
    if isinstance(ref, str):
        return (ref, 0)
    node, port = ref
    if isinstance(port, str) and not port.isdigit():
        if side == "dst":
            raise FlowgraphError(
                f"named port {port!r} on destination {node!r}: named ports "
                "select a source's output field; in-ports are integers"
            )
        return (str(node), port)
    return (str(node), int(port))


@dataclasses.dataclass
class _Node:
    block: Block
    # in_edges[in_port] = (src_node, src_out_port)
    in_edges: dict[int, Port]


class FlowgraphError(ValueError):
    pass


class Flowgraph:
    """Mutable graph builder; build() flattens to an immutable Block.

    >>> fg = Flowgraph()
    >>> fg.add("lp", fir_filter(taps))
    >>> fg.add("mag", complex_to_mag_squared())
    >>> fg.add_input("lp")
    >>> fg.connect("lp", "mag")
    >>> fg.set_outputs("mag")
    >>> blk = fg.build()          # a Block: run it with StreamExecutor
    """

    def __init__(self, name: str = "flowgraph"):
        self.name = name
        self._nodes: dict[str, _Node] = {}
        self._inputs: list[Port] = []   # (node, in_port) fed by graph input i
        self._outputs: list[Port] = []
        self._output_single = True

    # -- construction -------------------------------------------------------
    def add(self, node_id: str, block: Block) -> "Flowgraph":
        if node_id in self._nodes:
            raise FlowgraphError(f"duplicate node id {node_id!r}")
        if not isinstance(block, Block):
            raise FlowgraphError(
                f"node {node_id!r}: expected a Block, got {type(block).__name__}"
            )
        self._nodes[node_id] = _Node(block, {})
        return self

    def connect(self, src, dst) -> "Flowgraph":
        """connect('a', 'b') or connect(('a', out_port), ('b', in_port)) --
        the gr.top_block.connect equivalent."""
        s_node, s_port = _as_port(src)
        d_node, d_port = _as_port(dst, side="dst")
        for n in (s_node, d_node):
            if n not in self._nodes:
                raise FlowgraphError(f"unknown node {n!r}")
        dst_edges = self._nodes[d_node].in_edges
        if d_port in dst_edges:
            raise FlowgraphError(
                f"input port {d_node!r}:{d_port} already connected"
            )
        dst_edges[d_port] = (s_node, s_port)
        return self

    def add_input(self, dst) -> "Flowgraph":
        """Declare that the graph's next external input feeds `dst`
        (node or (node, in_port))."""
        d_node, d_port = _as_port(dst, side="dst")
        if d_node not in self._nodes:
            raise FlowgraphError(f"unknown node {d_node!r}")
        if d_port in self._nodes[d_node].in_edges:
            raise FlowgraphError(
                f"input port {d_node!r}:{d_port} already connected"
            )
        idx = len(self._inputs)
        self._inputs.append((d_node, d_port))
        self._nodes[d_node].in_edges[d_port] = ("__input__", idx)
        return self

    def set_outputs(self, *refs) -> "Flowgraph":
        self._outputs = [_as_port(r) for r in refs]
        self._output_single = len(refs) == 1
        for n, _ in self._outputs:
            if n not in self._nodes:
                raise FlowgraphError(f"unknown node {n!r}")
        return self

    # -- flattening ---------------------------------------------------------
    def _topo_order(self) -> list[str]:
        """Kahn's algorithm; raises on cycles and on unconnected in-ports."""
        deps: dict[str, set[str]] = {}
        for nid, node in self._nodes.items():
            ports = sorted(node.in_edges)
            if ports != list(range(len(ports))):
                raise FlowgraphError(
                    f"node {nid!r}: in-ports {ports} are not dense from 0 "
                    "(every port below the max must be connected)"
                )
            deps[nid] = {
                src for (src, _) in node.in_edges.values() if src != "__input__"
            }
        order, ready = [], sorted(n for n, d in deps.items() if not d)
        remaining = {n: set(d) for n, d in deps.items() if d}
        while ready:
            n = ready.pop(0)
            order.append(n)
            newly = []
            for m, d in list(remaining.items()):
                d.discard(n)
                if not d:
                    del remaining[m]
                    newly.append(m)
            ready.extend(sorted(newly))
        if remaining:
            raise FlowgraphError(f"cycle among nodes: {sorted(remaining)}")
        return order

    def build(self) -> Block:
        """Flatten to a single Block whose init takes the device."""
        if not self._nodes:
            raise FlowgraphError("empty flowgraph")
        if not self._outputs:
            raise FlowgraphError("set_outputs() was never called")
        order = self._topo_order()
        nodes = self._nodes
        n_inputs = len(self._inputs)
        outputs = list(self._outputs)
        single_out = self._output_single
        # latency composes ADDITIVELY along serial chains: the drain must
        # flush the longest input->output path, not just the worst node
        path_lat: dict[str, int] = {}
        for n in order:
            path_lat[n] = nodes[n].block.latency + max(
                (path_lat[s] for (s, _) in nodes[n].in_edges.values()
                 if s != "__input__"),
                default=0,
            )
        latency = max(path_lat[n] for n, _ in outputs)

        def init(device):
            return tuple(nodes[n].block.init(device) for n in order)

        def apply(states, x):
            if n_inputs <= 1:
                ext_in = (x,) if n_inputs else ()
            else:
                # tuple(tensor) would silently iterate it element-wise
                if not isinstance(x, (tuple, list)):
                    raise FlowgraphError(
                        f"graph expects a tuple of {n_inputs} inputs, got "
                        f"{type(x).__name__}"
                    )
                ext_in = tuple(x)
            if n_inputs and len(ext_in) != n_inputs:
                raise FlowgraphError(
                    f"graph expects {n_inputs} inputs, got {len(ext_in)}"
                )
            produced: dict[str, Any] = {}

            def read(port: Port):
                src, p = port
                if src == "__input__":
                    return ext_in[p]
                y = produced[src]
                # plain tuples are multi-port outputs; NamedTuples (e.g.
                # SpectrumSummary, TxStreamOut) are single structured values
                # whose fields are addressable as NAMED ports
                if isinstance(p, str):
                    if not hasattr(y, "_fields") or p not in y._fields:
                        raise FlowgraphError(
                            f"node {src!r} has no output field {p!r}"
                            + (f"; fields: {y._fields}" if hasattr(y, "_fields")
                               else " (output is not a NamedTuple)")
                        )
                    return getattr(y, p)
                if isinstance(y, tuple) and not hasattr(y, "_fields"):
                    return y[p]
                if p != 0:
                    raise FlowgraphError(
                        f"node {src!r} has a single output; port {p} invalid"
                    )
                return y

            new_states = []
            for nid, st in zip(order, states):
                node = nodes[nid]
                ins = [node.in_edges[k] for k in sorted(node.in_edges)]
                if len(ins) == 0:
                    xin = None
                elif len(ins) == 1:
                    xin = read(ins[0])
                else:
                    xin = tuple(read(e) for e in ins)
                st, y = node.block.apply(st, xin)
                produced[nid] = y
                new_states.append(st)
            outs = tuple(read(o) for o in outputs)
            return tuple(new_states), (outs[0] if single_out else outs)

        # a graph fed through a non-stream input (e.g. the PDU-fed TX) must
        # opt out of the executor's per-leaf block_size shape check too
        stream_input = all(
            nodes[n].block.stream_input for (n, _) in self._inputs
        )
        return Block(init, apply, name=self.name, latency=latency,
                     stream_input=stream_input)
