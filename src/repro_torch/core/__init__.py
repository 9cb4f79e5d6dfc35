"""The port's core library (module names follow the JAX package's):

  numerics     Eq.(1) +/-1-bit codec and integer oracles
  caat         charge-domain analog adder tree (mismatch, parasitics, INL)
  adc          ReLU-optimized single 8b SAR ADC
  macro        full-matmul macro simulation (row tiling, digital sums)
  calibration  output-based fine-tune compensation
  quant        W8A8 static quantization and the bit-serial baseline
  backend      ExecutionBackend registry + DeploymentPlan
  executor     spec-based front end over the backend registry
  energy       analytic energy / area / latency model of the 65nm macro
"""
