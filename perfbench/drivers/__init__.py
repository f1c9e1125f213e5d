"""One driver per kind of traffic: ``run(r)`` drives the program through a
window and returns its metrics, its records and what the comparison needs;
``reference(r, out, precision)`` runs the reference on the same inputs;
``as_program(ref, out)`` puts a reference run in the program's place (the
control); ``numbers(r, program, ref)`` compares."""
