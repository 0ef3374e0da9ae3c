"""The device simulation: state, the fused step and its runner, boundary
events, reservoirs, binning and scattering (import the modules directly)."""
