"""The benchmark's harness: traffic, the measured window, the reference check,
the device readings and the counts of operations and bytes."""
