"""Reference data the port carries as copies (the JAX package's golden/
modules import jax through their package).  tests/test_torch_package.py
checks each copy against its original."""
