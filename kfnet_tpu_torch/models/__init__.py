"""SCoordNet, OFlowNet and the KFNet filter step."""
