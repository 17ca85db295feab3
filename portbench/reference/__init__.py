"""The benchmark's plain reference: frozen copies of the port's plain
transport, environment, atmosphere, camera, controller, postfx and clipped
Adam (paths.py puts them together per timed path).  Imports nothing of the
program, of jax or of tpt."""
