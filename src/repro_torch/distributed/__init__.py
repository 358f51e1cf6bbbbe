"""distributed: logical sharding names and the expert-parallel MoE."""
