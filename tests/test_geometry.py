"""Geometry unit tests — ports the intents of the reference's live tests
(``test/Side.cpp``, ``test/Octant.cpp``, ``test/OctTree.cpp``)."""

import numpy as np
import pytest

from pressurepoissonsolver_tpu import geometry as geo
from pressurepoissonsolver_tpu.geometry import Tree, uniform_tree, refined_tree

def test_side_semantics():
    # axis / lower / opposite (Side.h:97-162)
    assert geo.side_axis(0) == 0 and geo.side_axis(1) == 0
    assert geo.side_axis(4) == 2 and geo.side_axis(5) == 2
    assert geo.side_is_lower(0) and not geo.side_is_lower(1)
    assert geo.side_opposite(0) == 1 and geo.side_opposite(3) == 2
    assert geo.side_opposite(5) == 4


def test_orthant_semantics_3d():
    # Octant.cpp intents: values, sides, neighbors
    bsw, tne = 0b000, 0b111
    assert geo.orthant_is_on_side(bsw, 0)  # west
    assert geo.orthant_is_on_side(bsw, 2)  # south
    assert geo.orthant_is_on_side(bsw, 4)  # bottom
    assert geo.orthant_is_on_side(tne, 1) and geo.orthant_is_on_side(tne, 3)
    assert geo.orthant_interior_nbr_on_side(bsw, 1) == 0b001
    assert geo.orthant_interior_nbr_on_side(bsw, 3) == 0b010
    assert geo.orthant_interior_nbr_on_side(bsw, 5) == 0b100
    assert set(geo.orthant_interior_sides(bsw, 3)) == {1, 3, 5}
    assert set(geo.orthant_exterior_sides(bsw, 3)) == {0, 2, 4}


def test_orthants_on_side_ordering():
    # Side.h:346-362: enumeration order = remaining-axis bits, low axis fast
    assert geo.orthants_on_side(0, 3) == [0b000, 0b010, 0b100, 0b110]  # west
    assert geo.orthants_on_side(1, 3) == [0b001, 0b011, 0b101, 0b111]  # east
    assert geo.orthants_on_side(2, 3) == [0b000, 0b001, 0b100, 0b101]  # south
    assert geo.orthants_on_side(4, 3) == [0b000, 0b001, 0b010, 0b011]  # bottom
    assert geo.orthants_on_side(0, 2) == [0b00, 0b10]
    assert geo.orthants_on_side(3, 2) == [0b10, 0b11]


def test_uniform_tree_2d():
    t = uniform_tree(2, 2)
    assert t.num_levels == 2
    assert len(t.nodes) == 5
    root = t.nodes[t.root]
    assert root.has_children()
    kids = [t.nodes[int(c)] for c in root.child_id]
    # sibling neighbor stitching (OctTree.h:190-196)
    assert int(kids[0].nbr_id[1]) == kids[1].id  # bsw east -> bse
    assert int(kids[1].nbr_id[0]) == kids[0].id
    assert int(kids[0].nbr_id[3]) == kids[2].id  # bsw north -> bnw
    assert int(kids[3].nbr_id[2]) == kids[1].id
    # geometry halving
    np.testing.assert_allclose(kids[0].lengths, [0.5, 0.5])
    np.testing.assert_allclose(kids[3].starts, [0.5, 0.5])


def test_refine_leaves_topology_3d():
    # OctTree.cpp:33-171 intents
    t = uniform_tree(3, 2)
    assert len(t.nodes) == 9
    t.refine_leaves()
    assert t.num_levels == 3
    assert len(t.nodes) == 9 + 64
    # every level-1 node now has children; cross-family stitching works
    root = t.nodes[t.root]
    k0 = t.nodes[int(root.child_id[0])]
    k1 = t.nodes[int(root.child_id[1])]
    # k0's bse grandchild's east nbr is k1's bsw grandchild
    g0 = t.nodes[int(k0.child_id[0b001])]
    g1 = t.nodes[int(k1.child_id[0b000])]
    assert int(g0.nbr_id[1]) == g1.id
    assert int(g1.nbr_id[0]) == g0.id


def test_read_reference_fixtures(tmp_path):
    """In-repo stand-ins for the reference's 3D fixtures (2uni, 3uni,
    2refine), written with ``Tree.to_file`` and read back."""

    def roundtrip(t, name):
        p = str(tmp_path / f"{name}.bin")
        t.to_file(p)
        return Tree.from_file(p, 3)

    t = roundtrip(uniform_tree(3, 2), "2uni")
    assert len(t.nodes) == 9
    assert t.num_levels == 2
    t3 = roundtrip(uniform_tree(3, 3), "3uni")
    assert len(t3.nodes) == 73
    assert t3.num_levels == 3
    tr = roundtrip(refined_tree(3, 2, 1), "2refine")
    assert len(tr.nodes) == 17
    assert tr.num_levels == 3
    # one level-1 node refined -> 8 leaves at level 2
    lv = [n.level for n in tr.nodes.values()]
    assert lv.count(2) == 8


def test_file_roundtrip(tmp_path):
    t = refined_tree(2, 2, 1)
    p = str(tmp_path / "t.bin")
    t.to_file(p)
    t2 = Tree.from_file(p, 2)
    assert len(t2.nodes) == len(t.nodes)
    assert t2.num_levels == t.num_levels
    for nid, n in t.nodes.items():
        n2 = t2.nodes[nid]
        assert n2.level == n.level and n2.parent == n.parent
        np.testing.assert_allclose(n2.starts, n.starts)
        np.testing.assert_array_equal(n2.nbr_id, n.nbr_id)
        np.testing.assert_array_equal(n2.child_id, n.child_id)


def test_refined_tree_2to1_balance():
    t = refined_tree(2, 3, 2)
    # all leaf pairs sharing a face differ by <= 1 level
    leaves = {nid: t.nodes[nid] for nid in t.leaves()}
    for nid, n in leaves.items():
        for s in range(4):
            if n.has_nbr(s):
                nbr = t.nodes[int(n.nbr_id[s])]
                if not nbr.has_children():
                    assert abs(nbr.level - n.level) <= 1
