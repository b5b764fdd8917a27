"""Domain/level-extraction tests — neighbor reciprocity invariants from the
reference's (disabled) ``test/DomainCollection.cpp`` plus pass-through
parent conventions (``ThundereggDomGen.h:152-163``)."""

import numpy as np

from pressurepoissonsolver_tpu import geometry as geo
from pressurepoissonsolver_tpu.domain import (
    NBR_COARSE,
    NBR_FINE,
    NBR_NONE,
    NBR_NORMAL,
    DomainHierarchy,
    extract_level,
    parent_slots,
)
from pressurepoissonsolver_tpu.geometry import Tree, refined_tree, uniform_tree


def test_uniform_level_extraction_2d():
    t = uniform_tree(2, 3)  # 4x4 leaves
    lvl = extract_level(t, 2, n=4)
    assert lvl.num_patches == 16
    assert (lvl.nbr_type != NBR_COARSE).all()
    assert (lvl.nbr_type != NBR_FINE).all()
    # every patch has a parent with a valid orthant
    assert (lvl.orth_on_parent >= 0).all()
    # boundary counts: 4 sides of 4 patches each are physical
    assert (lvl.nbr_type == NBR_NONE).sum() == 16
    # reciprocity of normal neighbors
    for p in range(16):
        for s in range(4):
            if lvl.nbr_type[p, s] == NBR_NORMAL:
                q = lvl.nbr_slot[p, s]
                assert lvl.nbr_type[q, geo.side_opposite(s)] == NBR_NORMAL
                assert lvl.nbr_slot[q, geo.side_opposite(s)] == p


def test_coarser_level_has_passthrough():
    t = refined_tree(2, 2, 1)  # 2x2 grid, one corner refined
    h = DomainHierarchy(t, n=4)
    assert len(h) == 3
    fine = h[0]
    # finest level: 3 coarse leaves (pass-through) + 4 fine leaves
    assert fine.num_patches == 7
    pt = fine.orth_on_parent < 0
    assert pt.sum() == 3
    # pass-through patches are their own parent
    np.testing.assert_array_equal(fine.parent_id[pt], fine.ids[pt])
    mid = h[1]
    assert mid.num_patches == 4
    coarse = h[2]
    assert coarse.num_patches == 1


def test_coarse_fine_reciprocity_2d():
    t = refined_tree(2, 2, 1)
    lvl = extract_level(t, 2, n=4)
    half = 2
    for p in range(lvl.num_patches):
        for s in range(4):
            if lvl.nbr_type[p, s] == NBR_COARSE:
                q = int(lvl.nbr_slot[p, s])
                so = geo.side_opposite(s)
                assert lvl.nbr_type[q, so] == NBR_FINE
                orth = int(lvl.coarse_orth[p, s])
                assert int(lvl.fine_nbr_slots[q, so, orth]) == p
            if lvl.nbr_type[p, s] == NBR_FINE:
                so = geo.side_opposite(s)
                for q_i in range(half):
                    fq = int(lvl.fine_nbr_slots[p, s, q_i])
                    assert lvl.nbr_type[fq, so] == NBR_COARSE
                    assert int(lvl.nbr_slot[fq, so]) == p
                    assert int(lvl.coarse_orth[fq, so]) == q_i


def test_parent_slots_roundtrip():
    t = refined_tree(2, 2, 1)
    h = DomainHierarchy(t, n=4)
    ps = parent_slots(h[0], h[1])
    assert ps.shape == (7,)
    fine, coarse = h[0], h[1]
    for i in range(7):
        if fine.orth_on_parent[i] >= 0:
            assert int(coarse.ids[ps[i]]) == int(fine.parent_id[i])
        else:
            assert int(coarse.ids[ps[i]]) == int(fine.ids[i])


def test_spacings_and_centers():
    t = uniform_tree(2, 2)
    lvl = extract_level(t, 1, n=4)
    np.testing.assert_allclose(lvl.spacings, 0.125)
    c = lvl.cell_centers()
    assert c.shape == (4, 4, 4, 2)
    # patch 0 is the bsw child: first cell center at h/2
    p0 = int(np.argmin(lvl.starts.sum(axis=1)))
    np.testing.assert_allclose(c[p0, 0, 0], [0.0625, 0.0625])
    # x varies along the last array axis
    np.testing.assert_allclose(c[p0, 0, 1, 0] - c[p0, 0, 0, 0], 0.125)
    np.testing.assert_allclose(c[p0, 1, 0, 1] - c[p0, 0, 0, 1], 0.125)


def test_neumann_flags():
    t = uniform_tree(2, 2)
    lvl = extract_level(t, 1, n=4, neumann=True)
    assert (lvl.neumann == (lvl.nbr_type == NBR_NONE)).all()
    lvl_d = extract_level(t, 1, n=4, neumann=False)
    assert not lvl_d.neumann.any()


def test_reference_mesh_hierarchy_3d(tmp_path):
    # 3D corner-refined octree (the stand-in for the reference's 2refine),
    # through the file reader
    p = str(tmp_path / "2refine.bin")
    refined_tree(3, 2, 1).to_file(p)
    t = Tree.from_file(p, 3)
    h = DomainHierarchy(t, n=4)
    assert len(h) == 3
    # finest: 7 pass-through coarse leaves + 8 fine leaves
    assert h[0].num_patches == 15
    assert (h[0].orth_on_parent < 0).sum() == 7
    assert h[1].num_patches == 8
    assert h[2].num_patches == 1
