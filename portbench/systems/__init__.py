"""The program's model kinds, one module each, named by a configuration's
``model`` key: how the benchmark makes a kind's rows and parameters from the
seed, and how it drives ``ppca_rs_tpu_torch`` with them."""
