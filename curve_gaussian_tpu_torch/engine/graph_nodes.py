"""What a captured CUDA graph holds, read through the CUDA driver API
(``libcuda``): its nodes by type and the names of its kernels.

A ``torch.cuda.CUDAGraph`` must be made with ``keep_graph=True`` for its
``cudaGraph_t`` to be read.  The counts do not depend on a profiler's
tracing.  Card only: the driver library is loaded at the first call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

# CUgraphNodeType (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
                    9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}
CU_MEMORYTYPE_DEVICE, CU_MEMORYTYPE_UNIFIED = 2, 4
CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2


class _Memcpy3D(ctypes.Structure):
    """CUDA_MEMCPY3D (cuda.h): the parameters of a memcpy node."""
    _fields_ = [(f"{side}{f}", t) for side in ("src", "dst") for f, t in (
        ("XInBytes", ctypes.c_size_t), ("Y", ctypes.c_size_t), ("Z", ctypes.c_size_t),
        ("LOD", ctypes.c_size_t), ("MemoryType", ctypes.c_int), ("Host", ctypes.c_void_p),
        ("Device", ctypes.c_uint64), ("Array", ctypes.c_void_p), ("Reserved", ctypes.c_void_p),
        ("Pitch", ctypes.c_size_t), ("Height", ctypes.c_size_t))] + [
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t)]


class _KernelParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h): the parameters of a kernel node;
    ``func`` is NULL where the node names its kernel by ``kern``."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (n, ctypes.c_uint) for n in ("gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                                     "blockDimY", "blockDimZ", "sharedMemBytes")] + [
        ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver(*names: str):
    """libcuda with the graph calls and `names` returning CUresult."""
    cu = ctypes.CDLL("libcuda.so.1")
    for n in ("cuGraphGetNodes", "cuGraphNodeGetType") + names:
        getattr(cu, n).restype = ctypes.c_int
    return cu


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed on the captured graph (CUresult {rc})")


def _nodes(cu, graph) -> list:
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        t = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)),
               "cuGraphNodeGetType")
        out.append((ctypes.c_void_p(node), GRAPH_NODE_TYPES.get(t.value, str(t.value))))
    return out


def graph_nodes(graph) -> Dict[str, int]:
    """{node type: count} of a captured graph.  A memcpy node counts as
    ``memcpy`` when it copies from device memory and as
    ``memcpy_from_host`` otherwise (a graph would read that host memory
    again at every replay)."""
    cu = _driver("cuGraphMemcpyNodeGetParams", "cuPointerGetAttribute")
    out: Dict[str, int] = {}
    for node, name in _nodes(cu, graph):
        if name == "memcpy":
            p = _Memcpy3D()
            _check(cu.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p)),
                   "cuGraphMemcpyNodeGetParams")
            kind = p.srcMemoryType
            if kind == CU_MEMORYTYPE_UNIFIED:  # the pointer says where it lies
                v = ctypes.c_uint(0)
                _check(cu.cuPointerGetAttribute(ctypes.byref(v), CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
                                                ctypes.c_uint64(p.srcDevice)),
                       "cuPointerGetAttribute")
                kind = v.value
            if kind != CU_MEMORYTYPE_DEVICE:
                name = "memcpy_from_host"
        out[name] = out.get(name, 0) + 1
    return out


def kernel_names(graph) -> List[str]:
    """The (mangled) function names of a captured graph's kernel nodes."""
    cu = _driver("cuGraphKernelNodeGetParams_v2", "cuFuncGetName", "cuKernelGetName")
    names = []
    for node, kind in _nodes(cu, graph):
        if kind != "kernel":
            continue
        p = _KernelParams()
        _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                   "cuKernelGetName")
        names.append(name.value.decode())
    return names


def nccl_kernels(graph) -> int:
    """The NCCL kernel nodes of a captured graph: the collectives captured
    into it."""
    return sum("nccl" in n.lower() for n in kernel_names(graph))
