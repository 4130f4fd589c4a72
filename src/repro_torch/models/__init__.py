"""The port's model zoo: the dense transformer family (``transformer``), its
layers, configs and the uniform API (``api``)."""
