"""The DWFL protocol: channel, privacy, exchange, train step, trajectory."""
