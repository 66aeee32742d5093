"""The sapling-spend cell on the CPU: its files load by name, the frozen
Spend circuit has the port's constraint count and input columns (so the
verifying key is the program's), and the reference's natively computed
public inputs are the ones the port's circuit exposes."""

import random

import run
from reference import groth16 as rg

from test_bench_port_reference import _merged, _port_columns


def test_cell_loads_by_name():
    from bellman_mpc_tpu_torch.utils import profiling

    profiling.reset()
    cell = run.Cell("sapling-spend.b4")
    assert (cell.chips, cell.batch, cell.pool) == (1, 4, 2)
    assert cell.config["constraints"] == 98777 and cell.config["domain"] == 1 << 17
    assert cell.config["reduced"] == []
    assert sorted(cell.readers) == ["h_ms_per_proof", "spend_synth_ms_per_proof"]
    assert all(r.read({}) is None for r in cell.readers.values())  # nothing recorded: nothing read


def test_frozen_circuit_and_public_inputs_are_the_ports():
    from bellman_mpc_tpu_torch.fields.bls12_381 import fr_host
    from bellman_mpc_tpu_torch.r1cs import TestConstraintSystem
    from bellman_mpc_tpu_torch.utils import profiling

    cell = run.Cell("sapling-spend.b4")
    cfg = cell.config
    n, cols = _port_columns(cell.program.circuits(cfg, [None])[0])
    cs = rg.InputColumns()
    cell.reference.circuit(cfg).synthesize(cs)
    cs.finish()
    assert cs.num_constraints == n == cfg["constraints_with_input_dummies"]
    assert 1 << rg.domain_exp(n) == cfg["domain"] and cs.num_inputs == cfg["inputs"]
    assert tuple(_merged(c) for c in cs.cols) == tuple(_merged(c) for c in cols)

    (w,) = cell.reference.draw_witnesses(cfg, random.Random(1234567890123), 1)
    tcs = TestConstraintSystem(fr_host)
    cell.program.circuits(cfg, [w])[0].synthesize(tcs)
    assert tcs.is_satisfied() and tcs.num_constraints() == cfg["constraints"]
    public = cell.reference.public_inputs(cfg, w)
    assert tcs.verify(public) and not tcs.verify(public[:4] + [public[4] + 1] + public[5:])
    profiling.reset()
