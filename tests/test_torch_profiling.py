"""utils/profiling.py's reader of a CUDA graph's DOT dump
(`parse_graph_dot`), on dumps in the form cudaGraphDebugDotPrint writes
(verbose): kernel nodes by their mangled symbols and memset and copy
nodes by their kind, in the dump's order. `graph_nodes` itself captures
on the card (tests/test_torch_kernels_cuda.py counts kernels with it)."""

from __future__ import annotations

import pytest

from cartseg_tpu_torch.utils.profiling import parse_graph_dot

_HEAD = 'digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" graph[style="dashed"];\n'


def _kernel(i: int, sym: str, grid: str = "1,128,0") -> str:
    return (f'"graph_1_node_{i}"[style="bold" shape="record" label="{{KERNEL\n'
            f"| {{ID | {i} (topoId: {9 - i}) | {sym}\\<\\<\\<{grid}\\>\\>\\>}}\n"
            "| {{node handle | func handle} | {0x000000000CDEE970 | "
            "0x000000000D89CB40}}\n"
            "| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | "
            "hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N "
            "| N}}\n| {cooperative | 0}\n| {priority | 0}\n}\"];\n\n")


def _memset(i: int) -> str:
    return (f'"graph_1_node_{i}"[style="solid" style="solid" shape="record" '
            'label="{MEMSET\n| {{ID | node handle | dptr | pitch | value | '
            f"elementSize | width | height}} | {{{i} (topoId: {9 - i}) | "
            "0x000000000CDEF0D8 | 0x00007F947E800200 | 0 | 0 | 1 | 8192 | "
            '1}}}"];\n\n')


_INIT = "_ZN41_GLOBAL__N__ca010676_9_median_cu_1539a6da11median_initEPjii"
_HIST = ("_ZN41_GLOBAL__N__ca010676_9_median_cu_1539a6da11median_histEPKjS1_"
         "Pjii")


def test_kernels_and_memsets_in_the_dumps_order():
    """The stream route's first pass as the card dumped it: a kernel, a
    memset, a kernel with a 2D grid (escaped braces in the label)."""
    text = (_HEAD + _kernel(0, _INIT) + _memset(1)
            + _kernel(2, _HIST, "\\{41,4\\},256,0") + "}\n}\n")
    assert parse_graph_dot(text) == [("KERNEL", _INIT), ("MEMSET", "MEMSET"),
                                     ("KERNEL", _HIST)]


@pytest.mark.parametrize("sym", [
    "_ZN12_GLOBAL__N_114median_clusterILi8EEEvPKfPfii",
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
    "St5arrayIPcLm1EEEEviT0_T1_",
    "cartseg_plain_c_kernel"])
def test_one_kernel_by_its_symbol(sym):
    """A C++ kernel by its mangled symbol, template arguments included;
    a kernel with C linkage by the name in its ID row."""
    assert parse_graph_dot(_HEAD + _kernel(0, sym) + "}\n}\n") == [
        ("KERNEL", sym)]


def test_other_kinds_and_an_empty_dump():
    """A copy node is read by its kind; a dump with no node gives no
    node (graph_nodes raises on that)."""
    copy = ('"graph_1_node_0"[style="solid" shape="record" label="{MEMCPY\n'
            '| {{ID | node handle | kind} | {0 (topoId: 0) | 0x1 | '
            'DtoD}}}"];\n')
    assert parse_graph_dot(_HEAD + copy + "}\n}\n") == [("MEMCPY", "MEMCPY")]
    assert parse_graph_dot(_HEAD + "}\n}\n") == []
