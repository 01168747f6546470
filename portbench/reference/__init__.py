"""The plain reference of the mastering chains that the benchmark's cells
time: the reference service's semantics (backend/app/pipeline.py and
chain.py of denisok-ai/audio-mastering-web) in NumPy and SciPy, in
float64, one track at its own length.

It imports nothing of the program (``amw_tpu_torch``) nor of the JAX
package, and takes none of the program's parameters: every filter, curve
and gain is designed here again from the configuration.  ``chains.py``
runs a whole configuration; ``dsp.py`` holds the stages; ``precision.py``
the rounding that turns the reference into the control (the same chain
with every stage's output rounded to bfloat16).
"""
