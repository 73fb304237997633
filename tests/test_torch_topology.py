"""The port's topology and route generator against ``repro.core``.

Route tables must be identical — next hops and output ports — for the two
tori of the paper's testbed, an irregular graph routed breadth-first, and
the snake bus (built by the reference's ``core/router.py`` and carried
across as its ``to_json()`` string)."""

import numpy as np
import pytest

from repro.core import Communicator as RefComm
from repro.core import Topology as RefTopology
from repro.core.router import snake_bus
from repro.core.routing import channel_dependency_acyclic as ref_acyclic
from repro_torch.core import Topology, channel_dependency_acyclic, compute_route_table
from repro_torch.interop import communicator_from_reference

# sorted, as Topology.to_json writes them, so the JSON round trip keeps
# every rank's port order
IRREGULAR_EDGES = [(0, 1), (0, 3), (1, 2), (1, 4), (2, 3), (2, 6), (3, 7), (4, 5), (4, 7),
                   (5, 6), (6, 7)]


def _ref_cases():
    return {
        "torus1x8": (RefComm.create("x", (8,)), ("x",), (8,)),
        "torus2x4": (RefComm.create(("x", "y"), (2, 4)), ("x", "y"), (2, 4)),
        "irregular_bfs": (RefComm.create("x", (8,), topology=RefTopology.from_edges(
            8, IRREGULAR_EDGES, name="irregular")), ("x",), (8,)),
        "snake_bus": (RefComm.create(("x", "y"), (2, 4), topology=RefTopology.from_json(
            snake_bus((2, 4)).to_json())), ("x", "y"), (2, 4)),
    }


@pytest.mark.parametrize("name", ["torus1x8", "torus2x4", "irregular_bfs", "snake_bus"])
def test_route_tables_identical(name):
    ref, names, sizes = _ref_cases()[name]
    port = communicator_from_reference(ref.topology.to_json(), names, sizes, device="cpu")
    assert port.topology.links == ref.topology.links
    assert port.topology.dims == ref.topology.dims
    np.testing.assert_array_equal(port.route_table.next_hop, ref.route_table.next_hop)
    np.testing.assert_array_equal(port.route_table.out_port, ref.route_table.out_port)
    for s in range(port.size):
        for d in range(port.size):
            assert port.route_table.path(s, d) == ref.route_table.path(s, d)
    assert channel_dependency_acyclic(port.route_table) == ref_acyclic(ref.route_table)


def test_snake_bus_routes_follow_the_reference_builder():
    """The JSON round trip keeps the bus: every next hop equals the one the
    reference's own snake-bus table gives."""
    snake = snake_bus((2, 4))
    ref = RefComm.create(("x", "y"), (2, 4), topology=snake)
    port = communicator_from_reference(snake.to_json(), ("x", "y"), (2, 4), device="cpu")
    np.testing.assert_array_equal(port.route_table.next_hop, ref.route_table.next_hop)
    assert port.topology.diameter() == snake.diameter() == 7


@pytest.mark.parametrize("dims", [(8,), (2, 4), (4, 4), (3, 5)])
@pytest.mark.parametrize("scheme", ["dor", "bfs"])
def test_torus_tables_and_acyclicity(dims, scheme):
    from repro.core.routing import compute_route_table as ref_table

    ours = compute_route_table(Topology.torus(dims), scheme)
    theirs = ref_table(RefTopology.torus(dims), scheme)
    np.testing.assert_array_equal(ours.next_hop, theirs.next_hop)
    np.testing.assert_array_equal(ours.out_port, theirs.out_port)
    assert channel_dependency_acyclic(ours) == ref_acyclic(theirs)
