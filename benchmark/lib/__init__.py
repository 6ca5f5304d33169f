"""The harness: manifest, inputs, weights, arithmetic, traces."""
