"""The benchmark's plain reference: BLS12-381 arithmetic, the Groth16
check of the window's proofs and frozen copies of the circuits.  It imports
nothing of the program."""
