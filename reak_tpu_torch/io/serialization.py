"""Scene/model serialization: typed JSON documents with a type registry
(port of ``reak_tpu/io/serialization.py``).

A replacement for the reference's RTTI + archive system
(ref: core/rtti/so_type.hpp:642 type repo, core/serialization/xml_archiver.hpp,
bin_archiver.hpp, protobuf_archiver.hpp, objtree_archiver.hpp, scheme_builder).

The RTTI magic-number hierarchy collapses into a string-tag registry mapping
type tags → (to_doc, from_doc) converters; object graphs become nested JSON
documents (arrays as lists).  This is the checkpoint system: chain specs,
scenes, planner options, solutions all round-trip.  Built-in registrations
cover ChainSpec, MPCProblem, shape records, proxy models, trajectories,
Gaussian beliefs and the planning queries and results.

The port writes the JAX package's archives byte for byte: the same tags
(``reak.ChainSpec``, …), the same document model, JSON layout (``indent=1``),
gzip path and ``RKB1`` binary layout, so an archive written by either
package loads in the other.  ``to_document`` takes torch tensors (copied to
the host) beside numpy arrays; ``from_document`` returns numpy arrays, and
``reak_tpu_torch.convert`` puts a loaded bundle on a device.

Two faults of the reference's schema builder are fixed here
(``_kind_of_annotation``): a bracketed ``List[...]``, ``Tuple[...]`` or
``Sequence[...]`` annotation is a ``sequence`` even where it names a
registered class (F3: the reference types ``"List[ShapeSet]"`` as
``object:reak.ShapeSet``), and a ``typing.ForwardRef`` — what a NamedTuple
declared under ``from __future__ import annotations`` keeps — is read by its
string (F17: the reference types such fields as ``any`` unless the text
``ndarray``/``Array``/``Optional`` happens to appear in the ForwardRef's
repr).  A ``torch.Tensor`` annotation is an ``array``, as ``jax.Array`` is.
"""
from __future__ import annotations

import dataclasses
import json
import re
import struct
from typing import Any, Callable, Dict, ForwardRef, Tuple

import numpy as np
import torch

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}
_TYPE_TAGS: Dict[type, str] = {}

# When set (by the binary archiver), to_document keeps ndarrays as raw
# np.ndarray nodes instead of JSON list-dicts, so the binary writer can emit
# them as contiguous bytes (the bin_archiver.hpp win over xml_archiver.hpp).
_RAW_ARRAYS = False


def register_type(tag: str, cls: type, to_doc=None, from_doc=None):
    """Register a serializable type (the RK_RTTI_MAKE_* macro equivalent,
    ref: core/rtti/typed_object.hpp:166)."""

    if to_doc is None or from_doc is None:
        if dataclasses.is_dataclass(cls):
            to_doc = lambda obj: {
                f.name: to_document(getattr(obj, f.name)) for f in dataclasses.fields(cls)
            }
            from_doc = lambda doc: cls(**{k: from_document(v) for k, v in doc.items()})
        elif hasattr(cls, "_fields"):  # NamedTuple
            to_doc = lambda obj: {f: to_document(getattr(obj, f)) for f in cls._fields}
            from_doc = lambda doc: cls(**{k: from_document(v) for k, v in doc.items()})
        else:
            raise TypeError(f"need explicit converters for {cls}")
    _REGISTRY[tag] = (to_doc, from_doc)
    _TYPE_TAGS[cls] = tag


def to_document(obj) -> Any:
    """Object → JSON-compatible document (tagged for registered types)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        a = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) \
            else obj
        if _RAW_ARRAYS:
            return a
        return {"__nd__": a.tolist(), "dtype": str(a.dtype), "shape": list(a.shape)}
    if isinstance(obj, np.generic):
        return obj.item()
    t = type(obj)
    if t in _TYPE_TAGS:
        tag = _TYPE_TAGS[t]
        return {"__type__": tag, "data": _REGISTRY[tag][0](obj)}
    if isinstance(obj, dict):
        return {k: to_document(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [to_document(v) for v in obj], "tuple": isinstance(obj, tuple)}
    raise TypeError(f"unserializable type {t} — call register_type first "
                    "(ref: rtti unregistered-type failure)")


def from_document(doc) -> Any:
    if doc is None or isinstance(doc, (bool, int, float, str)):
        return doc
    if isinstance(doc, np.ndarray):  # raw node from the binary archive
        return doc
    if isinstance(doc, dict):
        if "__nd__" in doc:
            return np.asarray(doc["__nd__"], dtype=doc["dtype"]).reshape(doc["shape"])
        if "__type__" in doc:
            tag = doc["__type__"]
            if tag not in _REGISTRY:
                raise KeyError(f"unknown type tag {tag!r} (ref: so_type_repo miss)")
            return _REGISTRY[tag][1](doc["data"])
        if "__seq__" in doc:
            seq = [from_document(v) for v in doc["__seq__"]]
            return tuple(seq) if doc.get("tuple") else seq
        return {k: from_document(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [from_document(v) for v in doc]
    raise TypeError(f"bad document node {type(doc)}")


# ---------------------------------------------------------------------------
# binary archive (ref: core/serialization/bin_archiver.hpp:107 — the compact
# row format; arrays stored as contiguous little-endian payloads)
# ---------------------------------------------------------------------------

_BIN_MAGIC = b"RKB1"
_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLT, _T_STR, _T_ARR, _T_MAP, _T_LST = \
    range(9)


def _bin_encode(node, out):
    if node is None:
        out.append(bytes([_T_NONE]))
    elif isinstance(node, bool):
        out.append(bytes([_T_TRUE if node else _T_FALSE]))
    elif isinstance(node, int):
        out.append(bytes([_T_INT]) + struct.pack("<q", node))
    elif isinstance(node, float):
        out.append(bytes([_T_FLT]) + struct.pack("<d", node))
    elif isinstance(node, str):
        b = node.encode()
        out.append(bytes([_T_STR]) + struct.pack("<I", len(b)) + b)
    elif isinstance(node, np.ndarray):
        a = np.ascontiguousarray(node)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        dt = str(a.dtype).encode()
        out.append(bytes([_T_ARR]) + struct.pack("<B", len(dt)) + dt
                   + struct.pack("<B", a.ndim)
                   + struct.pack(f"<{a.ndim}q", *a.shape)
                   + struct.pack("<Q", a.nbytes))
        out.append(a.tobytes())
    elif isinstance(node, dict):
        out.append(bytes([_T_MAP]) + struct.pack("<I", len(node)))
        for k, v in node.items():
            kb = k.encode()
            out.append(struct.pack("<I", len(kb)) + kb)
            _bin_encode(v, out)
    elif isinstance(node, (list, tuple)):
        out.append(bytes([_T_LST]) + struct.pack("<I", len(node)))
        for v in node:
            _bin_encode(v, out)
    else:
        raise TypeError(f"binary archive: unencodable node {type(node)}")


def _bin_decode(buf, off):
    t = buf[off]
    off += 1
    if t == _T_NONE:
        return None, off
    if t == _T_FALSE:
        return False, off
    if t == _T_TRUE:
        return True, off
    if t == _T_INT:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if t == _T_FLT:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if t == _T_STR:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return buf[off:off + n].decode(), off + n
    if t == _T_ARR:
        nd = buf[off]
        dt = buf[off + 1:off + 1 + nd].decode()
        off += 1 + nd
        ndim = buf[off]
        off += 1
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        nbytes = struct.unpack_from("<Q", buf, off)[0]
        off += 8
        a = np.frombuffer(buf[off:off + nbytes], dtype=dt).reshape(shape)
        return a.copy(), off + nbytes
    if t == _T_MAP:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            kl = struct.unpack_from("<I", buf, off)[0]
            off += 4
            k = buf[off:off + kl].decode()
            off += kl
            d[k], off = _bin_decode(buf, off)
        return d, off
    if t == _T_LST:
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        xs = []
        for _ in range(n):
            v, off = _bin_decode(buf, off)
            xs.append(v)
        return xs, off
    raise ValueError(f"binary archive: bad tag {t} at {off - 1}")


def save_scene_bin(path: str, obj):
    """Serialize to the compact binary archive (.rkb equivalent): same
    document model as JSON, ndarrays as contiguous little-endian payloads."""
    global _RAW_ARRAYS
    _RAW_ARRAYS = True
    try:
        doc = to_document(obj)
    finally:
        _RAW_ARRAYS = False
    out = [_BIN_MAGIC]
    _bin_encode(doc, out)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def load_scene_bin(path: str):
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _BIN_MAGIC:
        raise ValueError("not a reak binary archive (bad magic)")
    doc, off = _bin_decode(buf, 4)
    if off != len(buf):
        raise ValueError(f"trailing bytes in archive ({len(buf) - off})")
    return from_document(doc)


def save_scene(path: str, obj):
    """Serialize an object graph (the .rkx/.rkb equivalent): JSON by
    default, gzip-JSON for ``.gz`` paths, compact binary for ``.rkb``."""
    if path.endswith(".rkb"):
        return save_scene_bin(path, obj)
    doc = to_document(obj)
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "wt") as f:
            json.dump(doc, f)
    else:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)


def load_scene(path: str):
    if path.endswith(".rkb"):
        return load_scene_bin(path)
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            doc = json.load(f)
    else:
        with open(path) as f:
            doc = json.load(f)
    return from_document(doc)


# ---------------------------------------------------------------------------
# built-in registrations (the TypeIDList of the reference)
# ---------------------------------------------------------------------------


def _register_builtins():
    from reak_tpu_torch.kte.spec import ChainSpec
    from reak_tpu_torch.ctrl.mpc import MPCProblem
    from reak_tpu_torch.ctrl.belief import GaussianBelief
    from reak_tpu_torch.geom.shapes import (Sphere, Capsule, Box, Cylinder,
                                            Plane, ShapeSet)
    from reak_tpu_torch.geom.proximity import ProxyModel
    from reak_tpu_torch.interp.trajectory import Trajectory
    from reak_tpu_torch.planning.queries import PlanningQuery, PlanResult

    register_type("reak.ChainSpec", ChainSpec)
    register_type("reak.MPCProblem", MPCProblem)
    register_type("reak.GaussianBelief", GaussianBelief)
    register_type("reak.Sphere", Sphere)
    register_type("reak.Capsule", Capsule)
    register_type("reak.Box", Box)
    register_type("reak.Cylinder", Cylinder)
    register_type("reak.Plane", Plane)
    register_type("reak.ShapeSet", ShapeSet)
    register_type("reak.ProxyModel", ProxyModel)
    register_type("reak.Trajectory", Trajectory)
    register_type("reak.PlanningQuery", PlanningQuery)
    register_type("reak.PlanResult", PlanResult)


_register_builtins()


# ---------------------------------------------------------------------------
# self-describing schemas + editable object-tree view
# (ref: core/serialization/scheme_builder.hpp serialization schemes;
#  objtree_archiver.hpp:191 editable object-tree archive — the back-end of
#  the reference's property-editor GUI, here a headless node table)
# ---------------------------------------------------------------------------


# a bracketed container annotation, live or as a string (F3)
_CONTAINER = re.compile(r"^(typing\.)?(List|Tuple|Sequence|list|tuple)\[")


def _kind_of_annotation(ann) -> str:
    """Field annotation → schema kind string.

    Handles live type objects, STRING annotations (dataclasses in modules
    using ``from __future__ import annotations``, e.g. kte/spec.py, carry
    their field types as strings, so registered nested types are matched by
    class name) and ``typing.ForwardRef`` (what NamedTuples declared under
    that import keep: read by its string, F17).  A bracketed list, tuple or
    sequence is a ``sequence`` before any registered-name match (F3).
    """
    if isinstance(ann, ForwardRef):
        ann = ann.__forward_arg__
    name = getattr(ann, "__name__", None) or str(ann)
    if ann in (float,) or name == "float":
        return "float"
    if ann in (int,) or name == "int":
        return "int"
    if ann in (bool,) or name == "bool":
        return "bool"
    if ann in (str,) or name == "str":
        return "str"
    if isinstance(ann, type) and ann in _TYPE_TAGS:
        return f"object:{_TYPE_TAGS[ann]}"
    if _CONTAINER.match(str(ann)):
        return "sequence"
    if isinstance(ann, str):
        # string annotation naming a registered class ("ChainSpec",
        # "geom.shapes.ShapeSet", ...)
        by_name = {cls.__name__: tag for cls, tag in _TYPE_TAGS.items()}
        base = name.split("[")[-1].rstrip("]").split(".")[-1]
        if base in by_name and "Optional" not in name and "None" not in name:
            return f"object:{by_name[base]}"
    # Optional[...] must be detected BEFORE the inner type: a foreign tool
    # must know the field may be null in the archive
    if "Optional" in name or "None" in name:
        return "optional"
    if "ndarray" in name or "Array" in name or "Tensor" in name:
        return "array"
    if "Tuple" in name or "tuple" in name or "List" in name or "list" in name:
        return "sequence"
    return "any"


def build_schemes() -> dict:
    """Self-describing schema document for every registered type: field
    names + kinds introspected from the dataclass/NamedTuple definition
    (the scheme_builder.hpp role — lets foreign tools read/edit archives
    without importing this package)."""
    schemes = {}
    for cls, tag in _TYPE_TAGS.items():
        fields = []
        if dataclasses.is_dataclass(cls):
            for f in dataclasses.fields(cls):
                fields.append({"name": f.name,
                               "kind": _kind_of_annotation(f.type)})
        elif hasattr(cls, "_fields"):
            anns = getattr(cls, "__annotations__", {})
            for name in cls._fields:
                fields.append({"name": name,
                               "kind": _kind_of_annotation(anns.get(name))})
        schemes[tag] = {"class": cls.__name__,
                        "module": cls.__module__,
                        "fields": fields}
    return {"format": "reak-scheme-1", "schemes": schemes}


def save_schemes(path: str):
    """Write the schema document next to an archive (self-description)."""
    with open(path, "w") as f:
        json.dump(build_schemes(), f, indent=1, sort_keys=True)


def to_objtree(obj) -> dict:
    """Object graph → flat editable node table (objtree_archiver.hpp role):
    ``{"root": id, "nodes": {id: node}}`` where a node is one of
    ``{"kind": "value", "value": scalar}``, ``{"kind": "array", ...}``,
    ``{"kind": "object", "type": tag, "fields": {name: child_id}}``,
    ``{"kind": "map", "fields": ...}``, ``{"kind": "seq", "items": [...]}``.
    Stable integer ids allow field-level edits (``objtree_set``) before
    reconstruction with ``from_objtree`` — the reference's editable-archive
    workflow without the Qt object tree."""
    nodes = {}
    counter = [0]

    def add(node):
        nid = counter[0]
        counter[0] += 1
        nodes[nid] = node
        return nid

    def walk(doc):
        if doc is None or isinstance(doc, (bool, int, float, str)):
            return add({"kind": "value", "value": doc})
        if isinstance(doc, dict):
            if "__nd__" in doc:
                return add({"kind": "array", "value": doc["__nd__"],
                            "dtype": doc["dtype"], "shape": doc["shape"]})
            if "__type__" in doc:
                fields = {k: walk(v) for k, v in doc["data"].items()}
                return add({"kind": "object", "type": doc["__type__"],
                            "fields": fields})
            if "__seq__" in doc:
                items = [walk(v) for v in doc["__seq__"]]
                return add({"kind": "seq", "items": items,
                            "tuple": bool(doc.get("tuple"))})
            return add({"kind": "map",
                        "fields": {k: walk(v) for k, v in doc.items()}})
        raise TypeError(f"objtree: bad document node {type(doc)}")

    root = walk(to_document(obj))
    return {"format": "reak-objtree-1", "root": root, "nodes": nodes}


def objtree_set(tree: dict, node_id, value):
    """Edit a leaf node in place (value or array payload).  Accepts int or
    str node ids (JSON round-trips stringify the keys)."""
    nodes = tree["nodes"]
    node = nodes[node_id] if node_id in nodes else nodes[str(node_id)]
    if node["kind"] == "value":
        node["value"] = value
    elif node["kind"] == "array":
        a = np.asarray(value)
        node["value"] = a.tolist()
        node["dtype"] = str(a.dtype)
        node["shape"] = list(a.shape)
    else:
        raise TypeError(f"objtree_set: node {node_id} is a {node['kind']}, "
                        "not an editable leaf")


def from_objtree(tree: dict):
    """Reconstruct the object graph from a (possibly edited) node table."""
    nodes = tree["nodes"]

    def build(nid):
        node = nodes[nid] if nid in nodes else nodes[str(nid)]
        kind = node["kind"]
        if kind == "value":
            return node["value"]
        if kind == "array":
            return {"__nd__": node["value"], "dtype": node["dtype"],
                    "shape": node["shape"]}
        if kind == "object":
            return {"__type__": node["type"],
                    "data": {k: build(v) for k, v in node["fields"].items()}}
        if kind == "seq":
            return {"__seq__": [build(v) for v in node["items"]],
                    "tuple": node.get("tuple", False)}
        if kind == "map":
            return {k: build(v) for k, v in node["fields"].items()}
        raise TypeError(f"objtree: bad node kind {kind!r}")

    return from_document(build(tree["root"]))
