"""The port's archives (reak_tpu_torch.io.serialization), its scenario
bundles (kte.scenarios) and planning queries (planning.queries) against the
JAX package, on the CPU: every built-in type, both scenarios and
``EstimatorOptions``, written by one package and read by the other in each
of the three formats (``.json``, ``.json.gz``, ``.rkb``), every array bit
for bit; the same object gives the same ``.json`` and ``.rkb`` bytes in
both; the editable object tree; the failures (unregistered type, bad magic,
trailing bytes); and the schema document, equal to the JAX package's but
at the two faults of the reference that the port fixes, each asserted on a
test of its own: F3 (a bracketed ``List[ShapeSet]`` typed as the object
it holds) and F17 (NamedTuple fields kept as ``typing.ForwardRef`` typed
``any``)."""
import dataclasses
import json
import os
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reak_tpu.interp as jip
from reak_tpu.ctrl import belief as jbelief, mpc as jmpc
from reak_tpu.ctrl.options import EstimatorOptions as JOptions
from reak_tpu.geom import proximity as jprox, shapes as jshapes
from reak_tpu.io import serialization as jser
from reak_tpu.kte import models as jmodels, scenarios as jscen
from reak_tpu.planning import queries as jq
import reak_tpu_torch.interp as ip
from reak_tpu_torch import convert
from reak_tpu_torch.ctrl import belief, mpc
from reak_tpu_torch.ctrl.options import EstimatorOptions
from reak_tpu_torch.geom import proximity as prox, shapes
from reak_tpu_torch.io import serialization as ser
from reak_tpu_torch.kte import models, scenarios as scen
from reak_tpu_torch.planning import queries as q

FORMATS = [".json", ".json.gz", ".rkb"]


def _records(rng, mod_shapes, t):
    """One of each shape record, the same numpy values in both packages."""
    c = lambda *s: rng.uniform(-1.0, 1.0, s)
    quat = c(3, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return {"Sphere": mod_shapes.Sphere(t(c(3, 3)), t(c(3) + 1.5)),
            "Capsule": mod_shapes.Capsule(t(c(2, 3)), t(c(2, 3)), t(c(2) + 1.5)),
            "Box": mod_shapes.Box(t(c(3, 3)), t(quat), t(c(3, 3) + 1.5)),
            "Cylinder": mod_shapes.Cylinder(t(c(1, 3)), t(c(1, 3)), t(c(1) + 1.5)),
            "Plane": mod_shapes.Plane(t(c(1, 3)), t(c(1)))}


def _objects(side):
    """{name: object} of every registered type, built by the JAX package
    (``side == "jax"``) or the port from the same numpy values (seed 21)."""
    rng = np.random.default_rng(21)
    jx = side == "jax"
    t = jnp.asarray if jx else torch.as_tensor
    ti = (lambda a: jnp.asarray(a, jnp.int64)) if jx else (
        lambda a: torch.as_tensor(a, dtype=torch.int64))
    sh, px = (jshapes, jprox) if jx else (shapes, prox)
    rec = _records(rng, sh, t)
    Q, R = np.diag(rng.uniform(1, 2, 4)), np.diag(rng.uniform(0.1, 0.2, 2))
    cov = rng.standard_normal((4, 4))
    knots, pts = np.cumsum(rng.uniform(0.1, 0.5, 5)), rng.standard_normal((5, 3))
    vels, accs = rng.standard_normal((5, 3)), rng.standard_normal((5, 3))
    path = rng.standard_normal((6, 2))
    shape_set = sh.ShapeSet(spheres=rec["Sphere"], capsules=rec["Capsule"],
                            sphere_body=ti([0, 1, -1]),
                            capsule_body=ti([2, 2]))
    proxy = px.ProxyModel(spheres=rec["Sphere"], boxes=rec["Box"],
                          planes=rec["Plane"], cylinders=rec["Cylinder"])
    opts_kw = dict(system_kind="airship_aug", mass=2.0,
                   inertia_diag=(0.8, 1.0, 1.2), time_step=0.05,
                   measurements="pose_sonars", tsos=True,
                   measurement_noise=(1e-6,) * 6 + (1e-5,) * 6,
                   initial_cov_diag=(1e-2,) * 12 + (0.05,) * 5, steps=20)
    mods = (jmodels, jmpc, jbelief, jip, jq, jscen) if jx else (
        models, mpc, belief, ip, q, scen)
    m_models, m_mpc, m_belief, m_ip, m_q, m_scen = mods
    ct_shapes = sh.ShapeSet(spheres=sh.Sphere(t(np.zeros((1, 3))),
                                              t(np.array([0.2]))),
                            sphere_body=ti([0]))
    return {
        "ChainSpec": m_models.manip_3r3r(),
        "MPCProblem": m_mpc.MPCProblem(Q=t(Q), R=t(R), QN=t(5 * Q),
                                       u_min=t(-np.ones(2)),
                                       u_max=t(np.ones(2)), horizon=7),
        "GaussianBelief": m_belief.GaussianBelief(t(rng.standard_normal(4)),
                                                  t(cov @ cov.T)),
        **rec,
        "ShapeSet": shape_set,
        "ProxyModel": proxy,
        "Trajectory": m_ip.waypoint_trajectory(t(knots), t(pts)),
        "Trajectory_quintic": m_ip.waypoint_trajectory(t(knots), t(pts),
                                                       t(vels), t(accs)),
        "PlanningQuery": m_q.PlanningQuery(np.zeros(2), np.ones(2),
                                           goal_tolerance=0.1,
                                           time_budget=2.5),
        "PlanResult": m_q.PlanResult(True, path, 3.25, 17, 4, 0.125,
                                     {"rewires": 3, "note": "x"}),
        "NavigationScenario": (jscen.uav_corridor_scenario() if jx else
                               scen.uav_corridor_scenario(device="cpu")),
        "ChaserTargetScenario": m_scen.ChaserTargetScenario(
            name="grapple", chaser=m_models.manip_3r3r(),
            chaser_shapes=ct_shapes, target=m_models.free_floating_3d(),
            target_shapes=ct_shapes,
            env=px.ProxyModel(spheres=sh.Sphere(t(np.array([[1.0, 0, 0]])),
                                                t(np.array([0.3])))),
            start=t(np.zeros(6)), target_state=t(np.zeros(13))),
        "EstimatorOptions": (JOptions if jx else EstimatorOptions)(**opts_kw),
    }


NAMES = ["ChainSpec", "MPCProblem", "GaussianBelief", "Sphere", "Capsule",
         "Box", "Cylinder", "Plane", "ShapeSet", "ProxyModel", "Trajectory",
         "Trajectory_quintic", "PlanningQuery", "PlanResult",
         "NavigationScenario", "ChaserTargetScenario", "EstimatorOptions"]


def _same(got, want, package):
    """``got`` (loaded by ``package``) equals ``want``: the same class of
    that package, the same fields, every array bit for bit (dtype too)."""
    if isinstance(want, (np.ndarray, torch.Tensor)) or type(want).__module__ \
            .startswith("jax"):
        w = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        assert isinstance(got, np.ndarray)  # archives load numpy arrays
        assert got.dtype == w.dtype and got.shape == w.shape
        assert np.array_equal(got, w)
    elif dataclasses.is_dataclass(want) or hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__
        assert type(got).__module__.split(".")[0] == package
        names = ([f.name for f in dataclasses.fields(want)]
                 if dataclasses.is_dataclass(want) else want._fields)
        for f in names:
            _same(getattr(got, f), getattr(want, f), package)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k], package)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, package)
    else:
        assert type(got) is type(want) and got == want


@pytest.fixture(scope="module")
def objects():
    out = {"jax": _objects("jax"), "port": _objects("port")}
    assert sorted(out["port"]) == sorted(out["jax"]) == sorted(NAMES)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", NAMES)
def test_archive_loads_in_the_other_package(objects, tmp_path, name, fmt):
    """JAX save_scene → port load_scene, and port → JAX."""
    to_port, to_jax = str(tmp_path / f"j{fmt}"), str(tmp_path / f"p{fmt}")
    jser.save_scene(to_port, objects["jax"][name])
    _same(ser.load_scene(to_port), objects["port"][name], "reak_tpu_torch")
    ser.save_scene(to_jax, objects["port"][name])
    _same(jser.load_scene(to_jax), objects["jax"][name], "reak_tpu")


@pytest.mark.parametrize("name", NAMES)
def test_both_packages_write_the_same_bytes(objects, tmp_path, name):
    for fmt in (".json", ".rkb"):
        pj, pt = str(tmp_path / f"j{fmt}"), str(tmp_path / f"t{fmt}")
        jser.save_scene(pj, objects["jax"][name])
        ser.save_scene(pt, objects["port"][name])
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read(), fmt


def test_tensors_keep_their_dtype_and_composites_round_trip(tmp_path):
    """``to_document`` takes tensors of any float type (read back as numpy
    arrays of that type), and a dict scene of mixed nodes round-trips
    (tests/test_io.py's composite scenes)."""
    scene = {"chaser": models.planar_2link(),
             "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "i64": torch.tensor([3, -1]),
             "big": np.arange(4096, dtype=np.float32).reshape(64, 64),
             "flags": [True, False, None, 7, 2.5, "s", (1, 2)],
             "query": q.PlanningQuery(np.zeros(2), np.ones(2), 0.1)}
    sizes = {}
    for fmt in FORMATS:
        p = str(tmp_path / f"scene{fmt}")
        ser.save_scene(p, scene)
        sizes[fmt] = os.path.getsize(p)
        back = ser.load_scene(p)
        assert back["chaser"] == scene["chaser"]
        assert back["f32"].dtype == np.float32 and back["i64"].dtype == np.int64
        assert np.array_equal(back["f32"], scene["f32"].numpy())
        assert back["flags"] == scene["flags"]
        assert back["query"].goal_tolerance == 0.1
    assert sizes[".rkb"] < 0.5 * sizes[".json"]


def test_objtree_roundtrip_and_field_edit(objects):
    """The editable node table equals the JAX package's, round-trips, and a
    leaf edit reaches the rebuilt object (tests/test_io.py:256-285)."""
    spec = objects["port"]["ChainSpec"]
    tree = ser.to_objtree(spec)
    assert tree == jser.to_objtree(objects["jax"]["ChainSpec"])
    assert ser.from_objtree(tree) == spec
    root = tree["nodes"][tree["root"]]
    assert root["kind"] == "object" and root["type"] == "reak.ChainSpec"
    gnode = tree["nodes"][root["fields"]["gravity"]]
    ser.objtree_set(tree, gnode["items"][2], -1.62)
    assert ser.from_objtree(tree).gravity[2] == -1.62
    # an array leaf, through a JSON round trip (string node ids)
    tree = json.loads(json.dumps(ser.to_objtree(objects["port"]["Sphere"])))
    rid = tree["nodes"][str(tree["root"])]["fields"]["radius"]
    ser.objtree_set(tree, rid, np.array([0.5, 0.25], np.float32))
    sphere = ser.from_objtree(tree)
    assert type(sphere) is shapes.Sphere and sphere.radius.dtype == np.float32
    with pytest.raises(TypeError, match="editable leaf"):
        ser.objtree_set(tree, tree["root"], 1.0)


def test_unregistered_type_and_bad_archives_fail(tmp_path):
    class Foo:
        pass

    with pytest.raises(TypeError, match="register_type"):
        ser.to_document(Foo())
    with pytest.raises(KeyError, match="unknown type tag"):
        ser.from_document({"__type__": "reak.Nope", "data": {}})
    bad = tmp_path / "bad.rkb"
    bad.write_bytes(b"XXXX\x00")
    with pytest.raises(ValueError, match="magic"):
        ser.load_scene(str(bad))
    good = tmp_path / "good.rkb"
    ser.save_scene(str(good), [1, 2.0])
    good.write_bytes(good.read_bytes() + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        ser.load_scene(str(good))


def _kinds(doc):
    return {tag: {f["name"]: f["kind"] for f in s["fields"]}
            for tag, s in doc["schemes"].items()}


def _f17_kind(cls, field):
    """The kind the reference gives a NamedTuple field's annotation read
    as its string: what it would give without F17."""
    ann = cls.__annotations__[field]
    assert isinstance(ann, typing.ForwardRef)
    return jser._kind_of_annotation(ann.__forward_arg__)


def test_schemes_equal_the_jax_packages_but_for_f3_and_f17():
    """Every registered type has the JAX package's tag, class and fields;
    each kind is the JAX package's but where F17 types a NamedTuple field
    ``any`` for its ForwardRef (the port gives the kind of its string)."""
    mine, theirs = ser.build_schemes(), jser.build_schemes()
    assert mine["format"] == theirs["format"] == "reak-scheme-1"
    assert sorted(mine["schemes"]) == sorted(theirs["schemes"])
    jcls = {tag: cls for cls, tag in jser._TYPE_TAGS.items()}
    f17 = 0
    for tag, s in mine["schemes"].items():
        t = theirs["schemes"][tag]
        assert s["class"] == t["class"]
        assert s["module"] == t["module"].replace("reak_tpu.", "reak_tpu_torch.",
                                                  1)
        assert [f["name"] for f in s["fields"]] == [f["name"] for f in
                                                    t["fields"]]
        for a, b in zip(s["fields"], t["fields"]):
            if a["kind"] != b["kind"]:
                assert b["kind"] == "any", (tag, a, b)
                assert a["kind"] == _f17_kind(jcls[tag], a["name"]), (tag, a)
                f17 += 1
    assert f17 > 0


def test_f17_forward_ref_fields_are_typed_by_their_string():
    """NamedTuples declared under ``from __future__ import annotations`` keep
    ForwardRefs: the reference types the scenarios' nested objects ``any``
    (fault F17); the port types them as the objects they hold."""
    want = {"reak.NavigationScenario": {
                "name": "str", "robot": "object:reak.ChainSpec",
                "robot_shapes": "object:reak.ShapeSet",
                "env": "object:reak.ProxyModel"},
            "reak.ChaserTargetScenario": {
                "name": "str", "chaser": "object:reak.ChainSpec",
                "chaser_shapes": "object:reak.ShapeSet",
                "target": "object:reak.ChainSpec",
                "target_shapes": "object:reak.ShapeSet",
                "env": "object:reak.ProxyModel"},
            "reak.MPCProblem": {"horizon": "int"}}
    mine, theirs = _kinds(ser.build_schemes()), _kinds(jser.build_schemes())
    for tag, fields in want.items():
        for name, kind in fields.items():
            assert mine[tag][name] == kind
            assert theirs[tag][name] == "any"  # the reference's fault
    assert mine["reak.NavigationScenario"]["start"] == "array"
    assert ser._kind_of_annotation(typing.ForwardRef("Optional[ShapeSet]")) \
        == "optional"


@pytest.mark.parametrize("ann", ["List[ShapeSet]", "Tuple[ProxyModel]",
                                 "Sequence[ChainSpec]", "typing.List[Sphere]"])
def test_f3_bracketed_containers_are_sequences(ann):
    """The reference takes the last bracketed name of a string annotation,
    so a list of registered objects is typed as one of them (fault F3);
    the port types it ``sequence``."""
    assert ser._kind_of_annotation(ann) == "sequence"
    assert ser._kind_of_annotation(typing.ForwardRef(ann)) == "sequence"
    assert jser._kind_of_annotation(ann).startswith("object:")
    # the other annotations keep the reference's kinds
    for other in ("ShapeSet", "Optional[ShapeSet]", "np.ndarray", "float",
                  "Tuple[int, ...]", "dict", float, int, str, bool):
        assert ser._kind_of_annotation(other) == jser._kind_of_annotation(
            other)


def test_save_schemes_writes_the_sorted_document(tmp_path):
    p = str(tmp_path / "schemes.json")
    ser.save_schemes(p)
    with open(p) as f:
        assert json.load(f) == json.loads(json.dumps(ser.build_schemes()))


@pytest.mark.parametrize("name", ["NavigationScenario", "ChaserTargetScenario",
                                  "Trajectory_quintic"])
def test_convert_puts_a_loaded_bundle_on_a_device(objects, tmp_path, name):
    """A bundle the JAX package wrote, loaded by the port (numpy arrays),
    through ``convert``: the port's bundle, every tensor equal."""
    p = str(tmp_path / "b.rkb")
    jser.save_scene(p, objects["jax"][name])
    loaded = ser.load_scene(p)
    fn = {"NavigationScenario": convert.navigation_scenario_from,
          "ChaserTargetScenario": convert.chaser_target_scenario_from,
          "Trajectory_quintic": convert.interp_trajectory_from}[name]
    got, want = fn(loaded, "cpu", torch.float64), objects["port"][name]
    assert type(got) is type(want)
    flat = lambda x: [x] if isinstance(x, torch.Tensor) else (
        [y for f in x for y in flat(f)] if isinstance(x, tuple) else [])
    gl, wl = flat(got), flat(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if name == "NavigationScenario":
        assert got.robot == want.robot and got.name == want.name


def test_path_cost_matches_jax(objects):
    """``path_cost`` on a joint-space path and on a 1st-order bundle path
    (the sum of the space's distances between waypoints)."""
    import reak_tpu.spaces as jsp
    import reak_tpu_torch.spaces as sp

    rng = np.random.default_rng(2)
    path, qd = rng.uniform(-2, 2, (12, 6)), rng.uniform(-1, 1, (12, 6))
    lo, hi, v = -2.8 * np.ones(6), 2.8 * np.ones(6), np.full(6, 1.5)
    got = q.path_cost(sp.NdofSpace(lo, hi, device="cpu"),
                      torch.as_tensor(path))
    assert abs(got - jq.path_cost(jsp.NdofSpace(jnp.asarray(lo),
                                                jnp.asarray(hi)), path)) \
        <= 1e-12 * got
    s1, js1 = sp.Ndof1stOrderSpace(lo, hi, v, device="cpu"), \
        jsp.Ndof1stOrderSpace(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(v))
    got1 = q.path_cost(s1, sp.NdofPoint1(torch.as_tensor(path),
                                         torch.as_tensor(qd)))
    want1 = float(jnp.sum(js1.distance(
        jsp.NdofPoint1(jnp.asarray(path[:-1]), jnp.asarray(qd[:-1])),
        jsp.NdofPoint1(jnp.asarray(path[1:]), jnp.asarray(qd[1:])))))
    assert abs(got1 - want1) <= 1e-12 * want1
    assert q.path_cost(s1, None) == float("inf")
    assert q.path_cost(sp.NdofSpace(lo, hi, device="cpu"), path[:1]) \
        == float("inf")
