"""Multi-device training: process-group start-up (`distributed`) and the
data x model mesh with its sharding rules (`mesh`)."""
