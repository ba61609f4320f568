"""The TPUJob reconciler: status engine, object builders, controller."""
